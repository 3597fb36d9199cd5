"""Batched fair-sharing preemption: the problem encode and the decode.

The host half of kueue_tpu/solver/fairpreempt.py. The reference's
fairPreemptions (pkg/scheduler/preemption/preemption.go:312-437) pops
the ClusterQueue of the largest dominant resource share from a heap,
tests the configured strategy against the preemptor's and the
preemptee's shares, removes the candidate and re-heaps; then an optional
retry pass with the second strategy; then fill-back. Under fair sharing
every preempt-mode head of a cycle becomes one problem:

- build (build_fair_problems): get_targets_internal's dispatch with fair
  sharing on (preemption.go:131-172): a head whose candidates are all in
  its own CQ runs minimalPreemptions (a solver/preempt.py problem, K9),
  one with candidates in its cohort runs fairPreemptions (a FairProblem);
- encode (encode_fair_problems, fair_args): the PreemptionBatch layout,
  its slots extended to every FlavorResource a domain candidate holds,
  plus each candidate's rank within its CQ, each CQ's candidate count and
  first position (the heap's tie-break) and the per-CQ share constants of
  candidates.DomainCandidates.share_view;
- solve (kernel.solve_fair, the K11 kernel on the card), against the
  usage from before the cycle;
- decode (decode_fair_targets): the target masks and reason codes back to
  Target lists.

A CQ's dominant resource share (clusterqueue.go:503-564) is

    max over resources r of (borrowed[r] * 1000 // lendable[r])
        * 1000 // fair_weight

with borrowed[r] the sum of max(0, usage - nominal) over the CQ's
FlavorResources of resource r. Removals only move the slots' terms;
borrowing outside the slots ships as constants (base_other,
floor_ratio, floor_any). Equal shares pop in the order of each CQ's first
candidate in candidatesOrdering, as the CPU Preemptor's heap breaks them,
so both give the same targets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.scheduler import preemption as cpu_preempt
from kueue_tpu_torch.solver.preempt import (
    PreemptionBatch,
    PreemptionProblem,
    encode_problems,
)

# the share of a CQ of fair weight 0 (kueue_tpu/solver/fairpreempt.py:54)
MAXSHARE = np.int64(2**62)

# the kernel's reason codes -> the Preempted condition's reasons
_REASONS = (api.IN_CLUSTER_QUEUE_REASON,
            api.IN_COHORT_FAIR_SHARING_REASON,
            api.IN_COHORT_RECLAIM_WHILE_BORROWING_REASON)


@dataclass
class FairProblem(PreemptionProblem):
    """One fairPreemptions run. Its slots extend to the FlavorResources
    of every domain candidate (a removal moves each one of them)."""

    extra_frs: frozenset = frozenset()


@dataclass
class FairBatch(PreemptionBatch):
    """A PreemptionBatch plus the DRF-share inputs."""

    cand_rank: np.ndarray = None     # [B,K] int32 rank within its CQ (-1 pad)
    cq_count: np.ndarray = None      # [B,QL] int32 candidates per CQ
    cq_order: np.ndarray = None      # [B,QL] int32 first candidate position
                                     #   (the tie-break; 2**30 for none)
    base_other: np.ndarray = None    # [B,QL,RF] int64 borrowing on the
                                     #   slot's resource outside the slots
    floor_ratio: np.ndarray = None   # [B,QL] int64 ratio of the resources
                                     #   with no slot (-1 = none)
    floor_any: np.ndarray = None     # [B,QL] bool borrowing exists there
    weight: np.ndarray = None        # [B,QL] int64 fair weight (milli)
    lendable: np.ndarray = None      # [B,RF] int64 root lendable per slot


def build_fair_problems(entry_idx: int, wl, requests: dict,
                        frs_need_preemption: set, snapshot,
                        preemptor, cand_index) -> tuple:
    """get_targets_internal's dispatch under fair sharing
    (preemption.go:131-172 with enableFairSharing): an entry whose
    candidates are all in its own CQ runs minimalPreemptions, one with
    candidates in its cohort fairPreemptions. Returns (minimal problems,
    fair problems)."""
    cq = snapshot.cluster_queues[wl.cluster_queue]
    domain = cand_index.domain_for(cq)
    preemption = cq.preemption
    wl_prio = prioritypkg.priority(wl.obj)
    frs = frozenset(frs_need_preemption)
    sel = domain.select(
        cq.name, wl_prio,
        preemptor.ordering.queue_order_timestamp(wl.obj), frs,
        within_policy=preemption.within_cluster_queue,
        consider_same_prio=(preemption.within_cluster_queue
                            == api.PREEMPTION_LOWER_OR_NEWER_EQUAL_PRIORITY),
        reclaim_policy=preemption.reclaim_within_cohort,
        only_lower=(preemption.reclaim_within_cohort != api.PREEMPTION_ANY))
    if sel.size == 0:
        return [], []
    qi = domain.cq_index[cq.name]
    in_cq = domain.cq_of[sel] == qi
    if bool(in_cq.all()):
        return [PreemptionProblem(entry_idx, domain, sel,
                                  allow_borrowing=True)], []
    borrow_within, threshold = cpu_preempt.can_borrow_within_cohort(cq,
                                                                    wl.obj)
    fp = FairProblem(entry_idx, domain, sel, allow_borrowing=True,
                     threshold_active=borrow_within,
                     threshold=threshold if borrow_within else 0,
                     extra_frs=domain.all_frs())
    return [], [fp]


def encode_fair_problems(problems: list, snapshot, topo,
                         requests_by_entry: dict, wl_cq_by_entry: dict,
                         frs_np_by_entry: dict) -> FairBatch:
    """Fair problems -> arrays: encode_problems' layout (its slots
    extended by extra_frs) plus the per-candidate ranks and the per-CQ
    share constants."""
    base = encode_problems(problems, snapshot, topo, requests_by_entry,
                           wl_cq_by_entry, frs_np_by_entry)
    batch = FairBatch(**{f: getattr(base, f) for f in (
        "problems", "gq", "gf", "gr", "gc", "chain_local", "requests",
        "frs_np", "cand_idx", "cand_ql", "cand_usage", "cand_prio",
        "allow_borrowing", "threshold_active", "threshold", "has_cohort")})
    B, K = batch.cand_ql.shape
    QL = batch.gq.shape[1]
    RF = batch.gf.shape[1]
    batch.cand_rank = np.full((B, K), -1, np.int32)
    batch.cq_count = np.zeros((B, QL), np.int32)
    batch.cq_order = np.full((B, QL), 2**30, np.int32)
    batch.base_other = np.zeros((B, QL, RF), np.int64)
    batch.floor_ratio = np.full((B, QL), -1, np.int64)
    batch.floor_any = np.zeros((B, QL), bool)
    batch.weight = np.full((B, QL), 1000, np.int64)
    batch.lendable = np.zeros((B, RF), np.int64)

    for bi, p in enumerate(problems):
        k = p.num_candidates
        if k:
            # each candidate's rank within its CQ, each CQ's count and
            # first position
            q = batch.cand_ql[bi, :k].astype(np.int64)
            perm = np.argsort(q, kind="stable")
            sq = q[perm]
            pos = np.arange(k)
            first = np.r_[True, sq[1:] != sq[:-1]]
            seg_start = np.maximum.accumulate(np.where(first, pos, 0))
            rank = np.empty(k, np.int32)
            rank[perm] = (pos - seg_start).astype(np.int32)
            batch.cand_rank[bi, :k] = rank
            batch.cq_count[bi] = np.bincount(q, minlength=QL)[:QL]
            firsts = np.full(QL, 2**30, np.int64)
            np.minimum.at(firsts, q, pos)
            batch.cq_order[bi] = firsts.astype(np.int32)

        domain = p.domain
        req_frs = frozenset(requests_by_entry[p.entry_idx]) | p.extra_frs
        slots = domain.rows_view(req_frs).slots
        sv = domain.share_view(tuple(slots))
        # local CQ slot -> domain CQ, through gq (global CQ indices)
        name_by_global = {topo.cq_index[n]: n for n in domain.cq_names
                          if n in topo.cq_index}
        nslots = min(RF, sv["base_other"].shape[1])
        for lq in range(QL):
            name = name_by_global.get(int(batch.gq[bi, lq]))
            if name is None:
                continue
            di = domain.cq_index[name]
            batch.base_other[bi, lq, :nslots] = sv["base_other"][di, :nslots]
            batch.floor_ratio[bi, lq] = sv["floor_ratio"][di]
            batch.floor_any[bi, lq] = sv["floor_any"][di]
            batch.weight[bi, lq] = sv["weight"][di]
        nlend = min(RF, len(sv["lendable"]))
        batch.lendable[bi, :nlend] = sv["lendable"][:nlend]
    return batch


def fair_args(batch: FairBatch) -> tuple:
    """The batch's arrays in the order kernel.solve_fair takes them
    (kueue_tpu/solver/fairpreempt.py:192)."""
    return (batch.gq, batch.gf, batch.gr, batch.gc, batch.chain_local,
            batch.requests, batch.frs_np, batch.cand_idx, batch.cand_ql,
            batch.cand_usage, batch.cand_prio, batch.threshold_active,
            batch.threshold, batch.has_cohort, batch.cand_rank,
            batch.cq_count, batch.cq_order, batch.base_other,
            batch.floor_ratio, batch.floor_any, batch.weight,
            batch.lendable)


def strategy_flags(fs_strategies: list) -> tuple:
    """(strategy 0 is S2-a, a retry pass exists, strategy 1 is S2-a) of
    the Preemptor's fair-sharing strategies (scheduler/preemption.py
    parse_strategies)."""
    s0 = fs_strategies[0] is cpu_preempt._strategy_s2a
    has_retry = len(fs_strategies) > 1
    s1 = has_retry and fs_strategies[1] is cpu_preempt._strategy_s2a
    return (bool(s0), bool(has_retry), bool(s1))


def decode_fair_targets(batch: FairBatch, targets_mask: np.ndarray,
                        feasible: np.ndarray, reasons: np.ndarray,
                        snapshot, wl_cq_by_entry: dict) -> dict:
    """entry_idx -> list[Target] (one fair problem per entry), in
    candidate order, each with the reason of its code."""
    out: dict = {}
    for bi, p in enumerate(batch.problems):
        ei = p.entry_idx
        if not feasible[bi]:
            out.setdefault(ei, [])
            continue
        hit = np.flatnonzero(targets_mask[bi, :p.num_candidates])
        out[ei] = [cpu_preempt.Target(p.domain.infos[p.sel[ki]],
                                      _REASONS[int(reasons[bi, ki])])
                   for ki in hit.tolist()]
    return out
