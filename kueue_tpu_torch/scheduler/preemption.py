"""Preemption target selection and eviction issuing.

Equivalent of the reference's pkg/scheduler/preemption/preemption.go:
- findCandidates: lower-priority workloads in own CQ + borrowing CQs in
  the cohort per reclaimWithinCohort policy
- candidatesOrdering: evicted-first -> other-CQ-first -> lowest-priority
  -> most-recently-admitted
- minimalPreemptions: greedy remove until fit, then fill-back in reverse
- fairPreemptions: max-DRF-share CQ heap with strategies S2-a/S2-b
- the reclaim oracle feeding `reclaim` mode to the flavor assigner
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import find_condition
from kueue_tpu_torch.cache.snapshot import ClusterQueueSnapshot, Snapshot
from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.scheduler import flavorassigner as fa
from kueue_tpu_torch.utils.heap import Heap

PARALLEL_PREEMPTIONS = 8

HUMAN_READABLE_REASONS = {
    api.IN_CLUSTER_QUEUE_REASON: "prioritization in the ClusterQueue",
    api.IN_COHORT_RECLAMATION_REASON: "reclamation within the cohort",
    api.IN_COHORT_FAIR_SHARING_REASON: "fair sharing within the cohort",
    api.IN_COHORT_RECLAIM_WHILE_BORROWING_REASON:
        "reclamation within the cohort while borrowing",
}


@dataclass
class Target:
    workload_info: wlpkg.Info
    reason: str


def _strategy_s2a(preemptor_new_share, preemptee_old_share, preemptee_new_share) -> bool:
    """LessThanOrEqualToFinalShare (KEP-1714 rule S2-a)."""
    return preemptor_new_share <= preemptee_new_share


def _strategy_s2b(preemptor_new_share, preemptee_old_share, preemptee_new_share) -> bool:
    """LessThanInitialShare (rule S2-b)."""
    return preemptor_new_share < preemptee_old_share


def parse_strategies(names: list) -> list:
    if not names:
        return [_strategy_s2a, _strategy_s2b]
    mapping = {"LessThanOrEqualToFinalShare": _strategy_s2a,
               "LessThanInitialShare": _strategy_s2b}
    return [mapping[n] for n in names]


class Preemptor:
    def __init__(self, ordering: Optional[wlpkg.Ordering] = None,
                 enable_fair_sharing: bool = False,
                 fs_strategies: Optional[list] = None,
                 clock=None,
                 apply_preemption: Optional[Callable] = None):
        """apply_preemption(workload, preempting_cq, reason, message) performs the
        eviction write (SSA in the reference, store write here)."""
        from kueue_tpu_torch.api.meta import REAL_CLOCK
        self.ordering = ordering or wlpkg.Ordering()
        self.enable_fair_sharing = enable_fair_sharing
        self.fs_strategies = fs_strategies or parse_strategies(None)
        self.clock = clock or REAL_CLOCK
        self.apply_preemption = apply_preemption or (lambda wl, cq, reason, msg: None)
        # Eviction-issuing fan-out width (reference: preemption.go:195
        # uses 8). 1 = sequential: the right default for the in-process
        # store (see issue_preemptions docstring).
        self.eviction_workers = 1

    # --- entry points ---

    def get_targets(self, wl: wlpkg.Info, assignment: fa.Assignment,
                    snapshot: Snapshot) -> list:
        frs_need_preemption = fa.flavor_resources_need_preemption(assignment)
        requests = assignment.total_requests_for(wl)
        return self.get_targets_internal(wl, requests, frs_need_preemption, snapshot)

    def get_targets_internal(self, wl: wlpkg.Info, requests: dict,
                             frs_need_preemption: set, snapshot: Snapshot) -> list:
        cq = snapshot.cluster_queues[wl.cluster_queue]
        candidates = self.find_candidates(wl.obj, cq, frs_need_preemption)
        if not candidates:
            return []
        candidates.sort(key=self._candidate_sort_key(cq.name))

        same_queue_candidates = [c for c in candidates if c.cluster_queue == cq.name]

        # Borrowing while preempting others' workloads causes flapping; only
        # allowed via borrowWithinCohort or fair sharing
        # (reference: preemption.go:131-172).
        if len(same_queue_candidates) == len(candidates):
            return minimal_preemptions(requests, cq, snapshot, frs_need_preemption,
                                       candidates, True, None)

        borrow_within_cohort, threshold_prio = can_borrow_within_cohort(cq, wl.obj)
        if self.enable_fair_sharing:
            return self.fair_preemptions(wl, requests, snapshot, frs_need_preemption,
                                         candidates, threshold_prio)
        if borrow_within_cohort:
            if not queue_under_nominal(frs_need_preemption, cq):
                candidates = [c for c in candidates
                              if c.cluster_queue == cq.name
                              or prioritypkg.priority(c.obj) < threshold_prio]
            return minimal_preemptions(requests, cq, snapshot, frs_need_preemption,
                                       candidates, True, threshold_prio)

        if queue_under_nominal(frs_need_preemption, cq):
            targets = minimal_preemptions(requests, cq, snapshot, frs_need_preemption,
                                          candidates, False, None)
            if targets:
                return targets

        return minimal_preemptions(requests, cq, snapshot, frs_need_preemption,
                                   same_queue_candidates, True, None)

    def issue_preemptions(self, preemptor: wlpkg.Info, targets: list) -> int:
        """Mark targets evicted (reference: preemption.go:195-235, an
        8-way parallelize.Until fan-out). eviction_workers mirrors that
        knob: >1 fans out on the shared bounded pool — worth it only
        when apply_preemption blocks (a remote store); the in-process
        store is GIL-bound pure Python, where the measured fan-out is a
        ~10-20% loss even chunked (tools/measure_evictions.py), so the
        default stays sequential."""
        from kueue_tpu_torch.utils import parallelize

        def issue(i: int) -> None:
            target = targets[i]
            obj = target.workload_info.obj
            cond = find_condition(obj.status.conditions, api.WORKLOAD_EVICTED)
            if cond is None or cond.status != "True":
                message = (f"Preempted to accommodate a workload (UID: "
                           f"{preemptor.obj.metadata.uid}) due to "
                           f"{HUMAN_READABLE_REASONS[target.reason]}")
                self.apply_preemption(obj, preemptor.cluster_queue,
                                      target.reason, message)

        parallelize.until(len(targets), issue, workers=self.eviction_workers)
        return len(targets)

    # --- candidate discovery (reference: preemption.go:488-532) ---

    def find_candidates(self, wl: api.Workload, cq: ClusterQueueSnapshot,
                        frs_need_preemption: set) -> list:
        candidates = []
        wl_priority = prioritypkg.priority(wl)
        preemption = cq.preemption

        if preemption.within_cluster_queue != api.PREEMPTION_NEVER:
            consider_same_prio = (preemption.within_cluster_queue
                                  == api.PREEMPTION_LOWER_OR_NEWER_EQUAL_PRIORITY)
            preemptor_ts = self.ordering.queue_order_timestamp(wl)
            for cand in cq.workloads.values():
                cand_priority = prioritypkg.priority(cand.obj)
                if cand_priority > wl_priority:
                    continue
                if cand_priority == wl_priority and not (
                        consider_same_prio
                        and preemptor_ts < self.ordering.queue_order_timestamp(cand.obj)):
                    continue
                if not workload_uses_resources(cand, frs_need_preemption):
                    continue
                candidates.append(cand)

        if cq.cohort is not None and preemption.reclaim_within_cohort != api.PREEMPTION_NEVER:
            only_lower = preemption.reclaim_within_cohort != api.PREEMPTION_ANY
            # The borrowing domain spans the whole cohort tree for
            # hierarchical cohorts (root's subtree), which reduces to the
            # flat member set for single-level cohorts.
            for cohort_cq in cq.cohort.root().subtree_cqs():
                if cohort_cq is cq or not cq_is_borrowing(cohort_cq, frs_need_preemption):
                    continue
                for cand in cohort_cq.workloads.values():
                    if only_lower and prioritypkg.priority(cand.obj) >= wl_priority:
                        continue
                    if not workload_uses_resources(cand, frs_need_preemption):
                        continue
                    candidates.append(cand)
        return candidates

    def _candidate_sort_key(self, cq_name: str):
        """candidatesOrdering (reference: preemption.go:587-614). The
        status-derived components are memoized on the Info keyed by the
        object's resourceVersion (a candidate appears in many problems
        per cycle when cohorts share victims)."""
        now = self.clock.now()

        def sort_key(c: wlpkg.Info):
            obj = c.obj
            rv = obj.metadata.resource_version
            cached = getattr(c, "_cand_key_cache", None)
            if cached is None or cached[0] != rv:
                cond = find_condition(obj.status.conditions,
                                      api.WORKLOAD_QUOTA_RESERVED)
                reserved_at = (cond.last_transition_time
                               if cond and cond.status == "True" else None)
                cached = (rv, not wlpkg.is_evicted(obj),
                          prioritypkg.priority(obj), reserved_at,
                          obj.metadata.uid)
                c._cand_key_cache = cached
            _, not_evicted, prio, reserved_at, uid = cached
            in_cq = c.cluster_queue == cq_name
            return (not_evicted, in_cq, prio,
                    -(reserved_at if reserved_at is not None else now), uid)

        return sort_key

    # --- fair sharing (reference: preemption.go:343-438) ---

    def fair_preemptions(self, wl: wlpkg.Info, requests: dict, snapshot: Snapshot,
                         frs_need_preemption: set, candidates: list,
                         allow_borrowing_below_priority: Optional[int]) -> list:
        nominated_cq = snapshot.cluster_queues[wl.cluster_queue]
        # Determinized heap ties: equal-share CQs pop in order of their
        # first candidate's position in candidatesOrdering (the reference
        # leaves ties to binary-heap internals; the device kernel and this
        # path share this rule so decisions stay bit-comparable).
        first_pos: dict = {}
        for i, c in enumerate(candidates):
            first_pos.setdefault(c.cluster_queue, i)
        cq_heap = _cq_heap_from_candidates(candidates, False, snapshot,
                                           first_pos)
        new_nominated_share, _ = nominated_cq.dominant_resource_share_with(requests)
        targets: list = []
        fits = False
        retry_candidates: list = []
        while len(cq_heap) > 0 and not fits:
            cand_cq = cq_heap.pop()
            if cand_cq.cq is nominated_cq:
                cand_wl = cand_cq.workloads[0]
                snapshot.remove_workload(cand_wl)
                targets.append(Target(cand_wl, api.IN_CLUSTER_QUEUE_REASON))
                if workload_fits(requests, nominated_cq, True):
                    fits = True
                    break
                new_nominated_share, _ = nominated_cq.dominant_resource_share_with(requests)
                cand_cq.workloads = cand_cq.workloads[1:]
                if cand_cq.workloads:
                    cand_cq.share, _ = cand_cq.cq.dominant_resource_share()
                    cq_heap.push_if_not_present(cand_cq)
                continue

            for i, cand_wl in enumerate(cand_cq.workloads):
                below_threshold = (allow_borrowing_below_priority is not None
                                   and prioritypkg.priority(cand_wl.obj)
                                   < allow_borrowing_below_priority)
                new_cand_share, _ = cand_cq.cq.dominant_resource_share_without(
                    cand_wl.flavor_resource_usage())
                strategy_ok = self.fs_strategies[0](
                    new_nominated_share, cand_cq.share, new_cand_share)
                if below_threshold or strategy_ok:
                    snapshot.remove_workload(cand_wl)
                    reason = (api.IN_COHORT_FAIR_SHARING_REASON if strategy_ok
                              else api.IN_COHORT_RECLAIM_WHILE_BORROWING_REASON)
                    targets.append(Target(cand_wl, reason))
                    if workload_fits(requests, nominated_cq, True):
                        fits = True
                        break
                    cand_cq.workloads = cand_cq.workloads[i + 1:]
                    if cand_cq.workloads and cq_is_borrowing(cand_cq.cq, frs_need_preemption):
                        cand_cq.share = new_cand_share
                        cq_heap.push_if_not_present(cand_cq)
                    break
                else:
                    retry_candidates.append(cand_wl)

        if not fits and len(self.fs_strategies) > 1:
            cq_heap = _cq_heap_from_candidates(retry_candidates, True, snapshot,
                                               first_pos)
            while len(cq_heap) > 0 and not fits:
                cand_cq = cq_heap.pop()
                if self.fs_strategies[1](new_nominated_share, cand_cq.share, 0):
                    cand_wl = cand_cq.workloads[0]
                    snapshot.remove_workload(cand_wl)
                    targets.append(Target(cand_wl, api.IN_COHORT_FAIR_SHARING_REASON))
                    if workload_fits(requests, nominated_cq, True):
                        fits = True

        if not fits:
            _restore(snapshot, targets)
            return []
        targets = fill_back_workloads(targets, requests, nominated_cq, snapshot, True)
        _restore(snapshot, targets)
        return targets


def make_reclaim_oracle(preemptor: Preemptor, snapshot: Snapshot) -> Callable:
    """IsReclaimPossible (reference: preemption_oracle.go:40-51): the CQ can
    take fr/quantity back from the cohort without preempting its own
    workloads."""

    def is_reclaim_possible(cq: ClusterQueueSnapshot, wl: wlpkg.Info,
                            fr, quantity: int) -> bool:
        if cq.borrowing_with(fr, quantity):
            return False
        targets = preemptor.get_targets_internal(
            wl, {fr: quantity}, {fr}, snapshot)
        if not targets:
            return False
        return all(t.workload_info.cluster_queue != cq.name for t in targets)

    return is_reclaim_possible


# --- minimal preemption heuristic (reference: preemption.go:237-310) ---

def minimal_preemptions(requests: dict, cq: ClusterQueueSnapshot, snapshot: Snapshot,
                        frs_need_preemption: set, candidates: list,
                        allow_borrowing: bool,
                        allow_borrowing_below_priority: Optional[int]) -> list:
    targets: list = []
    fits = False
    for cand in candidates:
        cand_cq = snapshot.cluster_queues[cand.cluster_queue]
        reason = api.IN_CLUSTER_QUEUE_REASON
        if cq is not cand_cq:
            if not cq_is_borrowing(cand_cq, frs_need_preemption):
                continue
            reason = api.IN_COHORT_RECLAMATION_REASON
            if allow_borrowing_below_priority is not None:
                if prioritypkg.priority(cand.obj) >= allow_borrowing_below_priority:
                    # A candidate at/above the threshold forbids borrowing for
                    # the remainder (reference: preemption.go:252-270).
                    allow_borrowing = False
                else:
                    reason = api.IN_COHORT_RECLAIM_WHILE_BORROWING_REASON
        snapshot.remove_workload(cand)
        targets.append(Target(cand, reason))
        if workload_fits(requests, cq, allow_borrowing):
            fits = True
            break
    if not fits:
        _restore(snapshot, targets)
        return []
    targets = fill_back_workloads(targets, requests, cq, snapshot, allow_borrowing)
    _restore(snapshot, targets)
    return targets


def fill_back_workloads(targets: list, requests: dict, cq: ClusterQueueSnapshot,
                        snapshot: Snapshot, allow_borrowing: bool) -> list:
    for i in range(len(targets) - 2, -1, -1):
        snapshot.add_workload(targets[i].workload_info)
        if workload_fits(requests, cq, allow_borrowing):
            targets[i] = targets[-1]
            targets.pop()
        else:
            snapshot.remove_workload(targets[i].workload_info)
    return targets


def _restore(snapshot: Snapshot, targets: list) -> None:
    for t in targets:
        snapshot.add_workload(t.workload_info)


# --- helpers ---

def can_borrow_within_cohort(cq: ClusterQueueSnapshot, wl: api.Workload):
    bwc = cq.preemption.borrow_within_cohort
    if bwc is None or bwc.policy == api.BORROW_WITHIN_COHORT_NEVER:
        return False, None
    threshold = prioritypkg.priority(wl)
    if bwc.max_priority_threshold is not None and bwc.max_priority_threshold < threshold:
        threshold = bwc.max_priority_threshold + 1
    return True, threshold


def cq_is_borrowing(cq: ClusterQueueSnapshot, frs_need_preemption: set) -> bool:
    if cq.cohort is None:
        return False
    return any(cq.borrowing(fr) for fr in frs_need_preemption)


def workload_uses_resources(wl: wlpkg.Info, frs_need_preemption: set) -> bool:
    return not frs_need_preemption.isdisjoint(wl.flavor_resource_keys())


def workload_fits(requests: dict, cq: ClusterQueueSnapshot, allow_borrowing: bool) -> bool:
    for fr, v in requests.items():
        if not allow_borrowing and cq.borrowing_with(fr, v):
            return False
        if v > cq.available(fr):
            return False
    return True


def queue_under_nominal(frs_need_preemption: set, cq: ClusterQueueSnapshot) -> bool:
    return all(cq.usage_for(fr) < cq.quota_for(fr).nominal
               for fr in frs_need_preemption)


class _CandidateCQ:
    __slots__ = ("cq", "workloads", "share", "order")

    def __init__(self, cq, workloads, share, order=0):
        self.cq = cq
        self.workloads = workloads
        self.share = share
        self.order = order


def _cq_heap_from_candidates(candidates: list, first_only: bool,
                             snapshot: Snapshot,
                             first_pos: Optional[dict] = None) -> Heap:
    first_pos = first_pos or {}
    cq_heap: Heap = Heap(
        key_func=lambda c: c.cq.name,
        less_func=lambda a, b: (a.share > b.share
                                or (a.share == b.share
                                    and a.order < b.order)))
    for cand in candidates:
        existing = cq_heap.get_by_key(cand.cluster_queue)
        if existing is None:
            cq = snapshot.cluster_queues[cand.cluster_queue]
            share, _ = cq.dominant_resource_share()
            cq_heap.push_or_update(_CandidateCQ(
                cq, [cand], share,
                first_pos.get(cand.cluster_queue, 0)))
        elif not first_only:
            existing.workloads.append(cand)
    return cq_heap
