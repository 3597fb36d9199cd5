"""Per-workload, per-PodSet, per-resource-group flavor assignment.

Equivalent of the reference's pkg/scheduler/flavorassigner/flavorassigner.go:
walks the CQ's flavor list in order (resuming from LastTriedFlavorIdx —
the FlavorFungibility state machine), checking taints, node affinity and
quota fit; classifies each (flavor, resource) as fit/preempt/reclaim/noFit
with borrow flags; whenCanBorrow/whenCanPreempt policies decide whether to
try the next flavor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from kueue_tpu_torch import features
from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.corev1 import PodSpec, RESOURCE_PODS, find_untolerated_taint
from kueue_tpu_torch.cache.snapshot import ClusterQueueSnapshot
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.core.resources import FlavorResource

# API-level assignment modes, ordered by preference
# (reference: flavorassigner.go:205-233)
NO_FIT = 0
PREEMPT = 1
FIT = 2

# granular modes (reference: flavorassigner.go:238-258)
_G_NOFIT = 0
_G_PREEMPT = 1
_G_RECLAIM = 2
_G_FIT = 3


def _granular_to_api(mode: int) -> int:
    if mode == _G_FIT:
        return FIT
    if mode in (_G_PREEMPT, _G_RECLAIM):
        return PREEMPT
    return NO_FIT


def mode_name(mode: int) -> str:
    return {NO_FIT: "NoFit", PREEMPT: "Preempt", FIT: "Fit"}[mode]


@dataclass(slots=True)
class FlavorAssignment:
    name: str
    mode: int
    tried_flavor_idx: int = 0
    borrow: bool = False


@dataclass(slots=True)
class PodSetAssignmentResult:
    name: str = ""
    flavors: Optional[dict] = None  # resource -> FlavorAssignment
    reasons: list = field(default_factory=list)
    error: Optional[str] = None
    requests: dict = field(default_factory=dict)
    count: int = 0

    def representative_mode(self) -> int:
        if not self.reasons and self.error is None:
            return FIT
        if not self.flavors:
            return NO_FIT
        return min(fa.mode for fa in self.flavors.values())


@dataclass(slots=True)
class Assignment:
    pod_sets: list = field(default_factory=list)
    borrowing: bool = False
    usage: dict = field(default_factory=dict)  # FlavorResource -> int
    last_state: wlpkg.AssignmentClusterQueueState = field(
        default_factory=wlpkg.AssignmentClusterQueueState)
    _representative_mode: Optional[int] = None

    def borrows(self) -> bool:
        return self.borrowing

    def representative_mode(self) -> int:
        if not self.pod_sets:
            return NO_FIT
        if self._representative_mode is None:
            self._representative_mode = min(
                ps.representative_mode() for ps in self.pod_sets)
        return self._representative_mode

    def message(self) -> str:
        msgs = []
        for ps in self.pod_sets:
            if ps.error is not None:
                return f"failed to assign flavors to pod set {ps.name}: {ps.error}"
            if ps.reasons:
                msgs.append(f"couldn't assign flavors to pod set {ps.name}: "
                            + ", ".join(sorted(ps.reasons)))
        return "; ".join(msgs)

    def to_api(self) -> list:
        out = []
        for ps in self.pod_sets:
            flavors = {res: fa.name for res, fa in (ps.flavors or {}).items()}
            out.append(api.PodSetAssignment(
                name=ps.name, flavors=flavors,
                resource_usage=dict(ps.requests), count=ps.count))
        return out

    def total_requests_for(self, wl: wlpkg.Info) -> dict:
        usage: dict = {}
        for i, psr in enumerate(wl.total_requests):
            for res, q in psr.requests.items():
                flv = self.pod_sets[i].flavors[res].name if self.pod_sets[i].flavors else ""
                fr = FlavorResource(flv, res)
                usage[fr] = usage.get(fr, 0) + q
        return usage


def flavor_resources_need_preemption(assignment: Assignment) -> set:
    out = set()
    for ps in assignment.pod_sets:
        for res, fa in (ps.flavors or {}).items():
            if fa.mode == PREEMPT:
                out.add(FlavorResource(fa.name, res))
    return out


def flavor_selector_matches(pod_spec: PodSpec, allowed_keys: set,
                            flavor_labels: dict) -> bool:
    """Node-affinity match against flavor nodeLabels, restricted to the
    resource group's label keys (reference: flavorassigner.go:539-583)."""
    for k, v in pod_spec.node_selector.items():
        if k in allowed_keys and flavor_labels.get(k) != v:
            return False
    aff = pod_spec.affinity
    if aff and aff.node_affinity and aff.node_affinity.required:
        terms = []
        for t in aff.node_affinity.required.node_selector_terms:
            exprs = [e for e in t.match_expressions if e.key in allowed_keys]
            if not exprs:
                # An empty term matches everything and terms are ORed.
                terms = []
                break
            terms.append(exprs)
        if terms:
            matched = any(all(e.matches(flavor_labels) for e in exprs)
                          for exprs in terms)
            if not matched:
                return False
    return True


class FlavorAssigner:
    def __init__(self, wl: wlpkg.Info, cq: ClusterQueueSnapshot,
                 resource_flavors: dict, enable_fair_sharing: bool = False,
                 oracle: Optional[Callable] = None):
        """oracle(cq, wl, fr, quantity) -> bool: IsReclaimPossible."""
        self.wl = wl
        self.cq = cq
        self.resource_flavors = resource_flavors
        self.enable_fair_sharing = enable_fair_sharing
        self.oracle = oracle or (lambda cq, wl, fr, q: False)

    def assign(self, counts: Optional[list] = None) -> Assignment:
        if self.wl.last_assignment is not None and self._last_assignment_outdated():
            self.wl.last_assignment = None
        if not counts:
            return self._assign_flavors(self.wl.total_requests)
        scaled = [psr.scaled_to(counts[i]) for i, psr in enumerate(self.wl.total_requests)]
        return self._assign_flavors(scaled)

    def _last_assignment_outdated(self) -> bool:
        la = self.wl.last_assignment
        return (self.cq.allocatable_resource_generation > la.cluster_queue_generation
                or (self.cq.cohort is not None
                    and self.cq.cohort.allocatable_resource_generation > la.cohort_generation))

    def _assign_flavors(self, requests: list) -> Assignment:
        assignment = Assignment()
        assignment.last_state = wlpkg.AssignmentClusterQueueState(
            cluster_queue_generation=self.cq.allocatable_resource_generation,
            cohort_generation=(self.cq.cohort.allocatable_resource_generation
                               if self.cq.cohort else 0))

        for ps_idx, psr in enumerate(requests):
            ps_requests = dict(psr.requests)
            if self.cq.rg_by_resource(RESOURCE_PODS) is not None:
                ps_requests[RESOURCE_PODS] = psr.count

            ps_result = PodSetAssignmentResult(
                name=psr.name, flavors={}, requests=ps_requests, count=psr.count)

            for res_name in ps_requests:
                if res_name in ps_result.flavors:
                    continue  # covered by an earlier resource-group pass
                flavors, reasons, error = self._find_flavor_for_podset_resource(
                    ps_idx, ps_requests, res_name, assignment.usage)
                if error is not None or not flavors:
                    ps_result.flavors = None
                    ps_result.reasons = reasons
                    ps_result.error = error
                    break
                ps_result.flavors.update(flavors)
                ps_result.reasons.extend(reasons)

            self._append(assignment, ps_requests, ps_result)
            if ps_result.error is not None or (ps_requests and not ps_result.flavors):
                return assignment
        return assignment

    def _append(self, assignment: Assignment, requests: dict,
                ps: PodSetAssignmentResult) -> None:
        assignment.pod_sets.append(ps)
        flavor_idx = {}
        for res, fa in (ps.flavors or {}).items():
            if fa.borrow:
                assignment.borrowing = True
            fr = FlavorResource(fa.name, res)
            assignment.usage[fr] = assignment.usage.get(fr, 0) + requests[res]
            flavor_idx[res] = fa.tried_flavor_idx
        assignment.last_state.last_tried_flavor_idx.append(flavor_idx)

    def _find_flavor_for_podset_resource(self, ps_idx: int, requests: dict,
                                         res_name: str, assignment_usage: dict):
        """Returns (flavors: dict[res -> FlavorAssignment] | None,
        reasons: list, error: str | None)."""
        rg = self.cq.rg_by_resource(res_name)
        if rg is None:
            return None, [f"resource {res_name} unavailable in ClusterQueue"], None

        group_requests = {r: v for r, v in requests.items() if r in rg.covered_resources}
        pod_spec = self.wl.obj.spec.pod_sets[ps_idx].template.spec
        reasons: list = []
        best_assignment = None
        best_mode = _G_NOFIT
        attempted_idx = -1

        idx = (self.wl.last_assignment.next_flavor_to_try(ps_idx, res_name)
               if self.wl.last_assignment else 0)
        fungibility_on = features.enabled(features.FLAVOR_FUNGIBILITY)
        while idx < len(rg.flavors):
            attempted_idx = idx
            f_name = rg.flavors[idx]
            idx += 1
            flavor = self.resource_flavors.get(f_name)
            if flavor is None:
                reasons.append(f"flavor {f_name} not found")
                continue
            taint = find_untolerated_taint(flavor.spec.node_taints, pod_spec.tolerations)
            if taint is not None:
                reasons.append(f"untolerated taint {taint.key} in flavor {f_name}")
                continue
            if not flavor_selector_matches(pod_spec, rg.label_keys, flavor.spec.node_labels):
                reasons.append(f"flavor {f_name} doesn't match node affinity")
                continue

            needs_borrowing = False
            assignments: dict = {}
            representative_mode = _G_FIT
            for r_name, val in group_requests.items():
                fr = FlavorResource(f_name, r_name)
                mode, borrow, reason = self._fits_resource_quota(
                    fr, val + assignment_usage.get(fr, 0))
                if reason:
                    reasons.append(reason)
                representative_mode = min(representative_mode, mode)
                needs_borrowing = needs_borrowing or borrow
                if representative_mode == _G_NOFIT:
                    break
                assignments[r_name] = FlavorAssignment(
                    name=f_name, mode=_granular_to_api(mode), borrow=borrow)

            if fungibility_on:
                if not _should_try_next_flavor(representative_mode,
                                               self.cq.flavor_fungibility,
                                               needs_borrowing):
                    best_assignment = assignments
                    best_mode = representative_mode
                    break
                if representative_mode > best_mode:
                    best_assignment = assignments
                    best_mode = representative_mode
            elif representative_mode > best_mode:
                best_assignment = assignments
                best_mode = representative_mode
                if best_mode == _G_FIT:
                    return best_assignment, [], None

        if fungibility_on:
            for fa in (best_assignment or {}).values():
                # Reached the last flavor -> restart from the first next time.
                fa.tried_flavor_idx = (-1 if attempted_idx == len(rg.flavors) - 1
                                       else attempted_idx)
            if best_mode == _G_FIT:
                return best_assignment, [], None
        return best_assignment, reasons, None

    def _fits_resource_quota(self, fr: FlavorResource, val: int):
        """(granular mode, borrow, reason) — reference:
        flavorassigner.go:591-636."""
        reason = None
        borrow = False
        quota = self.cq.quota_for(fr)
        used = self.cq.usage_for(fr)
        mode = _G_NOFIT
        if val <= quota.nominal:
            # Could fit if quota is reclaimed from the cohort or all
            # workloads in the CQ are preempted.
            mode = _G_PREEMPT

        if self._can_preempt_while_borrowing():
            if ((quota.borrowing_limit is None
                 or val <= quota.nominal + quota.borrowing_limit)
                    and val <= self.cq.potential_available(fr)):
                mode = _G_PREEMPT
                borrow = val > quota.nominal
        if (quota.borrowing_limit is not None
                and used + val > quota.nominal + quota.borrowing_limit):
            return mode, borrow, (f"borrowing limit for {fr.resource} in flavor "
                                  f"{fr.flavor} exceeded")

        if self.oracle(self.cq, self.wl, fr, val):
            mode = _G_RECLAIM

        lack = val - self.cq.available(fr)
        if lack <= 0:
            return _G_FIT, used + val > quota.nominal, None

        if self.cq.cohort is None:
            if mode == _G_NOFIT:
                reason = (f"insufficient quota for {fr.resource} in flavor "
                          f"{fr.flavor} in ClusterQueue")
            else:
                reason = (f"insufficient unused quota for {fr.resource} in flavor "
                          f"{fr.flavor}, {lack} more needed")
        else:
            reason = (f"insufficient unused quota in cohort for {fr.resource} in "
                      f"flavor {fr.flavor}, {lack} more needed")
        return mode, borrow, reason

    def _can_preempt_while_borrowing(self) -> bool:
        p = self.cq.preemption
        return ((p.borrow_within_cohort is not None
                 and p.borrow_within_cohort.policy != api.BORROW_WITHIN_COHORT_NEVER)
                or (self.enable_fair_sharing
                    and p.reclaim_within_cohort != api.PREEMPTION_NEVER))


def _should_try_next_flavor(representative_mode: int,
                            fungibility: api.FlavorFungibility,
                            needs_borrowing: bool) -> bool:
    """reference: flavorassigner.go:519-537."""
    policy_preempt = fungibility.when_can_preempt
    policy_borrow = fungibility.when_can_borrow
    if representative_mode in (_G_PREEMPT, _G_RECLAIM) and policy_preempt == api.PREEMPT:
        if not needs_borrowing or policy_borrow == api.BORROW:
            return False
    if representative_mode == _G_FIT and needs_borrowing and policy_borrow == api.BORROW:
        return False
    if representative_mode == _G_FIT and not needs_borrowing:
        return False
    return True
