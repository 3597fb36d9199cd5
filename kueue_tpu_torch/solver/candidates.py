"""Array-native preemption candidate discovery for the solver path.

The port of kueue_tpu/solver/candidates.py, with the fair-sharing views
`all_frs` and `share_view` that solver/fairpreempt.py encodes for K11.
The reference discovers and orders
preemption candidates per preemptor (findCandidates +
candidatesOrdering, preemption.go:488-614): an O(cohort workloads) scan
and an O(K log K) sort per entry. This module builds, once per cycle per
conflict domain (root cohort or standalone CQ), numpy columns over the
domain's admitted workloads and one global pre-sort; each preemptor's
candidates then come out as boolean masks and slices:

- candidatesOrdering's key is (not_evicted, in_own_cq, priority,
  -reserved_at, uid); only in_own_cq depends on the preemptor, so the
  domain-wide order sorted by (not_evicted, priority, -reserved_at, uid)
  is partitioned into four stable groups per preemptor;
- workload-uses-resources and cq-is-borrowing are cached per
  FlavorResource set;
- the problem encode (solver/preempt.py) reads deduplicated per-domain
  usage-row tables, so shipping a problem to the card touches no
  per-candidate Python;
- fair-sharing problems (solver/fairpreempt.py) extend their slots to
  every FlavorResource a domain candidate holds (`all_frs`) and ship the
  per-CQ share constants of the slots (`share_view`).

The CPU Preemptor (scheduler/preemption.py) keeps its own sequential
discovery as the oracle the batched path is held to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import find_condition
from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.core import workload as wlpkg


@dataclass
class RowsView:
    """Per-(domain, request-FlavorResource-set) usage projection with a
    deduplicated (priority, usage row) table for the device upload."""

    slots: list                      # canonical (sorted) FlavorResource order
    row_of: np.ndarray = None        # [N] int32 index into table
    table_usage: np.ndarray = None   # [U,RF] int64
    table_prio: np.ndarray = None    # [U] int32


class DomainCandidates:
    """All admitted workloads of one conflict domain (a root cohort's
    subtree, or a standalone CQ), with the preemptor-independent part of
    candidatesOrdering precomputed."""

    def __init__(self, cq_snaps: list, ordering, now: float):
        self.cq_names = [c.name for c in cq_snaps]
        self.cq_index = {n: i for i, n in enumerate(self.cq_names)}
        self.cq_snaps = cq_snaps
        infos, cq_of, prio, ts, evicted, reserved, uids = \
            [], [], [], [], [], [], []
        for qi, cq in enumerate(cq_snaps):
            for info in cq.workloads.values():
                infos.append(info)
                cq_of.append(qi)
                prio.append(prioritypkg.priority(info.obj))
                ts.append(ordering.queue_order_timestamp(info.obj))
                cond = find_condition(info.obj.status.conditions,
                                      api.WORKLOAD_QUOTA_RESERVED)
                reserved.append(cond.last_transition_time
                                if cond is not None and cond.status == "True"
                                else now)
                evicted.append(wlpkg.is_evicted(info.obj))
                uids.append(info.obj.metadata.uid)
        n = len(infos)
        self.n = n
        self.infos = infos
        self.cq_of = np.asarray(cq_of, np.int32) if n else np.zeros(0, np.int32)
        self.prio = np.asarray(prio, np.int64) if n else np.zeros(0, np.int64)
        self.ts = np.asarray(ts, np.float64) if n else np.zeros(0)
        self.evicted = np.asarray(evicted, bool) if n else np.zeros(0, bool)
        self.reserved = np.asarray(reserved, np.float64) if n else np.zeros(0)
        if n:
            _, uid_codes = np.unique(np.asarray(uids, object),
                                     return_inverse=True)
            # the preemptor-independent part of candidatesOrdering
            # (preemption.go:587-614): ascending (not_evicted, prio,
            # -reserved_at, uid)
            self.order = np.lexsort((uid_codes, -self.reserved, self.prio,
                                     ~self.evicted))
        else:
            self.order = np.zeros(0, np.int64)
        self._rows_views: dict = {}
        self._uses_masks: dict = {}
        self._borrowing_masks: dict = {}
        self._all_frs: Optional[frozenset] = None
        self._share_views: dict = {}

    def all_frs(self) -> frozenset:
        """The FlavorResources any candidate of the domain holds: the slot
        extension of a fair problem (a removal moves every one of them,
        and each feeds dominantResourceShare)."""
        if self._all_frs is None:
            out: set = set()
            for info in self.infos:
                out.update(info.flavor_resource_keys())
            self._all_frs = frozenset(out)
        return self._all_frs

    def share_view(self, slots: tuple) -> dict:
        """Per-CQ DRF-share constants for the slot order `slots`
        (dominantResourceShare, clusterqueue.go:503-564, decomposed):
        borrowing on FlavorResources outside the slots does not move
        during a fair scan, so it ships as a per-(CQ, slot) constant on
        the slot's resource (`base_other`) and, for resources with no
        slot, as a ratio floor (`floor_ratio`, -1 for none) with its
        borrowing bit (`floor_any`); with each CQ's fair `weight` and the
        root cohort's `lendable` per slot."""
        view = self._share_views.get(slots)
        if view is not None:
            return view
        Qd = len(self.cq_snaps)
        RF = max(1, len(slots))
        base = np.zeros((Qd, RF), np.int64)
        floor_ratio = np.full(Qd, -1, np.int64)
        floor_any = np.zeros(Qd, bool)
        weight = np.asarray([cq.fair_weight for cq in self.cq_snaps],
                            np.int64)
        root = (self.cq_snaps[0].cohort.root()
                if self.cq_snaps and self.cq_snaps[0].cohort is not None
                else None)
        lendable_map = (root.resource_node.calculate_lendable()
                        if root is not None else {})
        lendable = np.asarray(
            [lendable_map.get(fr.resource, 0) for fr in slots] or [0],
            np.int64)
        slot_set = set(slots)
        slot_resources = {fr.resource for fr in slots}
        for qi, cq in enumerate(self.cq_snaps):
            extra: dict = {}
            for fr, used in cq.resource_node.usage.items():
                b = used - cq.quota_for(fr).nominal
                if b <= 0 or fr in slot_set:
                    continue
                extra[fr.resource] = extra.get(fr.resource, 0) + b
            for r, b in extra.items():
                if r in slot_resources:
                    for i, fr in enumerate(slots):
                        if fr.resource == r:
                            base[qi, i] = b
                else:
                    floor_any[qi] = True
                    lr = lendable_map.get(r, 0)
                    if lr > 0:
                        floor_ratio[qi] = max(floor_ratio[qi],
                                              b * 1000 // lr)
        view = {"base_other": base, "floor_ratio": floor_ratio,
                "floor_any": floor_any, "weight": weight,
                "lendable": lendable}
        self._share_views[slots] = view
        return view

    def uses_mask(self, frs: frozenset) -> np.ndarray:
        """[N] bool — workloadUsesResources per candidate."""
        mask = self._uses_masks.get(frs)
        if mask is None:
            mask = np.fromiter(
                (not frs.isdisjoint(i.flavor_resource_keys())
                 for i in self.infos), bool, self.n)
            self._uses_masks[frs] = mask
        return mask

    def borrowing_mask(self, frs: frozenset) -> np.ndarray:
        """[Q] bool — cqIsBorrowing per local CQ."""
        mask = self._borrowing_masks.get(frs)
        if mask is None:
            mask = np.asarray(
                [cq.cohort is not None and any(cq.borrowing(fr) for fr in frs)
                 for cq in self.cq_snaps], bool)
            self._borrowing_masks[frs] = mask
        return mask

    def rows_view(self, req_frs: frozenset) -> RowsView:
        view = self._rows_views.get(req_frs)
        if view is not None:
            return view
        slots = sorted(req_frs)
        n = self.n
        RF = max(1, len(slots))
        slot_of = {fr: i for i, fr in enumerate(slots)}
        rows = np.zeros((n, RF), np.int64)
        for i, info in enumerate(self.infos):
            for fr, v in info.flavor_resource_usage().items():
                si = slot_of.get(fr)
                if si is not None:
                    rows[i, si] = v
        view = RowsView(slots=slots)
        if n:
            combo = np.concatenate([self.prio[:, None], rows], axis=1)
            uniq, inv = np.unique(combo, axis=0, return_inverse=True)
            view.row_of = inv.reshape(-1).astype(np.int32)
            view.table_prio = uniq[:, 0].astype(np.int32)
            view.table_usage = uniq[:, 1:].astype(np.int64)
        else:
            view.row_of = np.zeros(0, np.int32)
            view.table_prio = np.zeros(0, np.int32)
            view.table_usage = np.zeros((0, RF), np.int64)
        self._rows_views[req_frs] = view
        return view

    def select(self, cq_name: str, wl_prio: int, preemptor_ts: float,
               frs: frozenset, within_policy: str, consider_same_prio: bool,
               reclaim_policy: str, only_lower: bool) -> np.ndarray:
        """findCandidates + candidatesOrdering (preemption.go:488-614) as
        mask algebra. Returns ordered candidate indices."""
        uses = self.uses_mask(frs)
        qi = self.cq_index[cq_name]
        in_cq = self.cq_of == qi

        mask = np.zeros(self.n, bool)
        if within_policy != api.PREEMPTION_NEVER:
            own = in_cq & uses & (
                (self.prio < wl_prio)
                | ((self.prio == wl_prio) & consider_same_prio
                   & (preemptor_ts < self.ts)))
            mask |= own
        if len(self.cq_snaps) > 1 and reclaim_policy != api.PREEMPTION_NEVER:
            other = (~in_cq) & uses & self.borrowing_mask(frs)[self.cq_of]
            if only_lower:
                other &= self.prio < wl_prio
            mask |= other

        om = self.order[mask[self.order]]
        if om.size == 0:
            return om
        # interleave the preemptor-specific in_cq key: four stable
        # partitions of the global order
        ev = self.evicted[om]
        own = in_cq[om]
        return np.concatenate([om[ev & ~own], om[ev & own],
                               om[~ev & ~own], om[~ev & own]])


class CandidateIndex:
    """Lazy per-snapshot index: conflict domain -> DomainCandidates."""

    def __init__(self, snapshot, ordering, now: float):
        self.snapshot = snapshot
        self.ordering = ordering
        self.now = now
        self._domains: dict = {}

    def domain_for(self, cq_snap) -> DomainCandidates:
        if cq_snap.cohort is not None:
            root = cq_snap.cohort.root()
            key = ("cohort", root.name)
            if key not in self._domains:
                self._domains[key] = DomainCandidates(
                    sorted(root.subtree_cqs(), key=lambda c: c.name),
                    self.ordering, self.now)
        else:
            key = ("cq", cq_snap.name)
            if key not in self._domains:
                self._domains[key] = DomainCandidates(
                    [cq_snap], self.ordering, self.now)
        return self._domains[key]


def candidate_index(snapshot, ordering, now: float) -> CandidateIndex:
    """The cycle's CandidateIndex, cached on the snapshot."""
    idx = getattr(snapshot, "_candidate_index", None)
    if idx is None:
        idx = CandidateIndex(snapshot, ordering, now)
        snapshot._candidate_index = idx
    return idx
