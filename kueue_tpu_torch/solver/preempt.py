"""Batched minimal preemption: the problem encode and the target decode.

The host half of kueue_tpu/solver/preempt.py. The reference's
minimalPreemptions (remove candidates in order until the preemptor fits,
then fill back in reverse; pkg/scheduler/preemption/preemption.go:
237-310) runs for every preempt-mode head of a cycle as one batch:

- encode (here and solver/candidates.py): candidate discovery and
  ordering as mask algebra over the cycle's CandidateIndex, the policy
  dispatch of get_targets_internal (preemption.go:116-171) as up to two
  "problems" per head, and the problems as padded tensors of GLOBAL
  indices (CQ, flavor, resource, cohort) into the solver's topology and
  usage, with the candidates' usage rows deduplicated into one table;
- solve (kernel.solve_preempt, the K9 kernel on the card): every
  candidate prefix at once, the first that fits, then the fill-back
  auction rounds, against the usage from before the cycle;
- decode (decode_targets): the target masks back to Target lists with
  their Preempted reasons, the first feasible problem of each head
  winning.

Fair-sharing preemption (solver/fairpreempt.py, the K11 kernel) builds on
this module's problem layout: its problems carry extra slots
(`extra_frs`), which encode_problems adds to the request's.

The CPU Preemptor (scheduler/preemption.py) is the oracle the batched
path is held to.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.scheduler import preemption as cpu_preempt
from kueue_tpu_torch.solver.encode import _bucket


@dataclass
class PreemptionProblem:
    """One minimal_preemptions run, as an ordered index selection into a
    DomainCandidates (solver/candidates.py): no per-candidate Python
    objects are made until decode."""

    entry_idx: int = -1
    domain: object = None            # candidates.DomainCandidates
    sel: np.ndarray = None           # ordered candidate indices into domain
    allow_borrowing: bool = True
    threshold_active: bool = False
    threshold: int = 0

    @property
    def num_candidates(self) -> int:
        return int(self.sel.size) if self.sel is not None else 0


@dataclass
class PreemptionBatch:
    problems: list = field(default_factory=list)
    # leading axis = problem; all indices GLOBAL
    gq: np.ndarray = None             # [B,QL] int32 global CQ (-1 pad);
                                      #   row 0 = the preemptor's CQ
    gf: np.ndarray = None             # [B,RF] int32 global flavor (-1 pad)
    gr: np.ndarray = None             # [B,RF] int32 global resource
    gc: np.ndarray = None             # [B,CL] int32 global cohort (-1 pad):
                                      #   the union of the problem CQs'
                                      #   chains
    chain_local: np.ndarray = None    # [B,QL,DC] int32 local cohort ids
    requests: np.ndarray = None       # [B,RF] int64
    frs_np: np.ndarray = None         # [B,RF] bool — needs-preemption frs
    # candidates as indices into a deduplicated row table (identical pod
    # shapes dominate real queues)
    cand_idx: np.ndarray = None       # [B,K] int32 (0 = the padding row)
    cand_ql: np.ndarray = None        # [B,K] int16 LOCAL CQ slot (-1 pad)
    cand_usage: np.ndarray = None     # [U,RF] int64 table
    cand_prio: np.ndarray = None      # [U] int32 table
    allow_borrowing: np.ndarray = None   # [B] bool
    threshold_active: np.ndarray = None  # [B] bool
    threshold: np.ndarray = None         # [B] int64
    has_cohort: np.ndarray = None        # [B] bool


def build_problems(entry_idx: int, wl, requests: dict,
                   frs_need_preemption: set, snapshot,
                   preemptor: "cpu_preempt.Preemptor", cand_index) -> list:
    """get_targets_internal's policy dispatch (preemption.go:116-171) as
    a list of 1-2 PreemptionProblems (the first non-empty result wins),
    with candidate discovery and ordering as mask algebra over the
    cycle's CandidateIndex."""
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
        return []
    qi = domain.cq_index[cq.name]
    in_cq = domain.cq_of[sel] == qi

    if bool(in_cq.all()):
        return [PreemptionProblem(entry_idx, domain, sel,
                                  allow_borrowing=True)]

    borrow_within, threshold = cpu_preempt.can_borrow_within_cohort(cq,
                                                                    wl.obj)
    if borrow_within:
        s = sel
        if not cpu_preempt.queue_under_nominal(frs_need_preemption, cq):
            s = sel[in_cq | (domain.prio[sel] < threshold)]
        return [PreemptionProblem(entry_idx, domain, s, allow_borrowing=True,
                                  threshold_active=True, threshold=threshold)]

    problems = []
    if cpu_preempt.queue_under_nominal(frs_need_preemption, cq):
        problems.append(PreemptionProblem(entry_idx, domain, sel,
                                          allow_borrowing=False))
    problems.append(PreemptionProblem(entry_idx, domain, sel[in_cq],
                                      allow_borrowing=True))
    return problems


def encode_problems(problems: list, snapshot, topo, requests_by_entry: dict,
                    wl_cq_by_entry: dict,
                    frs_np_by_entry: dict) -> PreemptionBatch:
    """Problems -> global-index arrays, with no per-candidate Python: the
    candidates' usage rows come from the per-domain deduplicated tables
    (candidates.RowsView), each problem's candidate columns are gathers
    over its index selection, and the batch table is the concatenation
    of the domain tables. Every dimension is bucketed as the JAX package
    buckets it (B, K, QL, CL, RF and the table's U), so both packages
    encode a cycle to arrays of the same shapes."""
    B = _bucket(max(1, len(problems)), 1)
    # fair problems (solver/fairpreempt.py) extend their slots past the
    # request's FlavorResources: extra_frs, the ones a removal moves
    RF = _bucket(max(max((len(_slot_frs(p, requests_by_entry))
                          for p in problems), default=1), 1))
    K = _bucket(max(max((p.num_candidates for p in problems), default=1), 1))

    batch = PreemptionBatch(problems=list(problems))
    batch.gf = np.full((B, RF), -1, np.int32)
    batch.gr = np.full((B, RF), 0, np.int32)
    batch.requests = np.zeros((B, RF), np.int64)
    batch.frs_np = np.zeros((B, RF), bool)
    batch.cand_idx = np.zeros((B, K), np.int32)
    batch.cand_ql = np.full((B, K), -1, np.int16)
    batch.allow_borrowing = np.zeros(B, bool)
    batch.threshold_active = np.zeros(B, bool)
    batch.threshold = np.zeros(B, np.int64)
    batch.has_cohort = np.zeros(B, bool)

    cq_index = topo.cq_index
    flavor_index = topo.flavor_index
    resource_index = topo.resource_index

    # the batch's candidate row table: the per-(domain, request frs)
    # tables one after another; row 0 is the padding row
    table_usage = [np.zeros((1, RF), np.int64)]
    table_prio = [np.zeros(1, np.int32)]
    offsets: dict = {}
    next_off = 1

    gq_rows = []
    max_ql = 1
    for bi, p in enumerate(problems):
        ei = p.entry_idx
        requests = requests_by_entry[ei]
        frs_np = frs_np_by_entry[ei]
        preemptor_cq = wl_cq_by_entry[ei]
        domain = p.domain
        req_frs = _slot_frs(p, requests_by_entry)
        rows = domain.rows_view(req_frs)

        for i, fr in enumerate(rows.slots):
            batch.gf[bi, i] = flavor_index.get(fr.flavor, -1)
            batch.gr[bi, i] = resource_index.get(fr.resource, 0)
            batch.requests[bi, i] = requests.get(fr, 0)
            batch.frs_np[bi, i] = fr in frs_np

        okey = (id(domain), req_frs)
        off = offsets.get(okey)
        if off is None:
            off = next_off
            offsets[okey] = off
            u = rows.table_usage
            if u.shape[1] < RF:
                u = np.pad(u, ((0, 0), (0, RF - u.shape[1])))
            table_usage.append(u)
            table_prio.append(rows.table_prio)
            next_off += len(rows.table_prio)

        sel = p.sel
        k = sel.size
        pre_qi = domain.cq_index[preemptor_cq]
        if k:
            batch.cand_idx[bi, :k] = off + rows.row_of[sel]
            # problem-local CQ slots: the preemptor's first, then in order
            # of first appearance
            cqs = domain.cq_of[sel]
            if cqs[0] == pre_qi and (cqs == pre_qi).all():
                batch.cand_ql[bi, :k] = 0  # within-CQ problem
                local_list = [pre_qi]
            else:
                uniq, first = np.unique(cqs, return_index=True)
                occ = uniq[np.argsort(first)]
                local_list = [pre_qi] + [int(c) for c in occ if c != pre_qi]
                lut = np.full(len(domain.cq_names), -1, np.int16)
                lut[local_list] = np.arange(len(local_list), dtype=np.int16)
                batch.cand_ql[bi, :k] = lut[cqs]
                max_ql = max(max_ql, len(local_list))
        else:
            local_list = [pre_qi]
        gq_rows.append([cq_index[domain.cq_names[c]] for c in local_list])

        batch.allow_borrowing[bi] = p.allow_borrowing
        batch.threshold_active[bi] = p.threshold_active
        batch.threshold[bi] = p.threshold if p.threshold_active else 0
        batch.has_cohort[bi] = \
            snapshot.cluster_queues[preemptor_cq].cohort is not None

    QL = _bucket(max_ql, 1)
    batch.gq = np.full((B, QL), -1, np.int32)
    for bi, row in enumerate(gq_rows):
        batch.gq[bi, :len(row)] = row
    # the table's row count is bucketed like every other dimension;
    # padding rows are all zero and no cand_idx points at them
    U = _bucket(next_off, 1)
    pad = U - next_off
    if pad:
        table_usage.append(np.zeros((pad, RF), np.int64))
        table_prio.append(np.zeros(pad, np.int32))
    batch.cand_usage = np.concatenate(table_usage, axis=0)
    batch.cand_prio = np.concatenate(table_prio)
    localize_cohorts(batch, topo.cq_chain)
    return batch


def _slot_frs(problem, requests_by_entry: dict) -> frozenset:
    """The FlavorResources a problem's slots carry: its entry's request,
    plus a fair problem's extra_frs."""
    return frozenset(requests_by_entry[problem.entry_idx]) | \
        getattr(problem, "extra_frs", frozenset())


def localize_cohorts(batch: PreemptionBatch, cq_chain: np.ndarray) -> None:
    """kueue_tpu/solver/preempt.py:272 _localize_cohorts. Per problem,
    project the global cohort chains of its CQs onto a small local id
    space (the union of those chains, ascending), so the state a problem
    carries is [CL,RF] instead of the whole cohort plane: sets batch.gc
    and batch.chain_local."""
    B, QL = batch.gq.shape
    DC = cq_chain.shape[1]
    q_safe = np.maximum(batch.gq, 0)
    chains = cq_chain[q_safe]                           # [B,QL,DC]
    chains = np.where((batch.gq >= 0)[:, :, None], chains, -1)
    SENT = np.int32(2**30)
    flat = chains.reshape(B, QL * DC).astype(np.int32)
    flat_s = np.where(flat < 0, SENT, flat)
    srt = np.sort(flat_s, axis=1)                       # valid asc, SENT last
    first = np.ones_like(srt, bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    first &= srt != SENT
    counts = first.sum(axis=1)
    CL = _bucket(max(1, int(counts.max())) if B else 1)
    loc_sorted = np.cumsum(first, axis=1) - 1           # [B,QL*DC]
    gc = np.full((B, CL), -1, np.int32)
    rows = np.nonzero(first)[0]
    gc[rows, loc_sorted[first]] = srt[first]
    # local id of each chain entry: the count of distinct valid ids below
    gc_cmp = np.where(gc >= 0, gc, SENT)                # [B,CL]
    local = (gc_cmp[:, None, :] < flat_s[:, :, None]).sum(axis=2)
    batch.chain_local = np.where(flat >= 0, local,
                                 -1).reshape(B, QL, DC).astype(np.int32)
    batch.gc = gc


class PreemptArgs(tuple):
    """preempt_args' arrays, in the order kernel.solve_preempt takes them,
    with the batch's `active_slots`: the most slots of any problem that
    have a request or a needs-preemption flag (active_slot_count), counted
    once from the host arrays. The compositions that take a preempt_args
    tuple hand it to solve_preempt; map() keeps it across an upload."""

    def __new__(cls, arrays, active_slots: int):
        self = super().__new__(cls, arrays)
        self.active_slots = active_slots
        return self

    def map(self, fn) -> "PreemptArgs":
        return PreemptArgs((fn(a) for a in self), self.active_slots)


def preempt_args(batch: PreemptionBatch) -> PreemptArgs:
    """The batch's arrays in the order kernel.solve_preempt takes them
    (kueue_tpu/solver/preempt.py:767), with their active slot count."""
    return PreemptArgs(
        (batch.gq, batch.gf, batch.gr, batch.gc, batch.chain_local,
         batch.requests, batch.frs_np, batch.cand_idx, batch.cand_ql,
         batch.cand_usage, batch.cand_prio, batch.allow_borrowing,
         batch.threshold_active, batch.threshold, batch.has_cohort),
        active_slot_count(batch.requests, batch.frs_np))


def active_slot_count(requests: np.ndarray, frs_np: np.ndarray) -> int:
    """The most active slots of any problem of a batch's requests[B,RF]
    and frs_np[B,RF]: a slot with a request or a needs-preemption flag
    (kernel.solve_preempt's active_slots)."""
    if requests.size == 0:
        return 0
    return int(((requests > 0) | frs_np).sum(1).max())


def decode_targets(batch: PreemptionBatch, targets_mask: np.ndarray,
                   feasible: np.ndarray, snapshot,
                   wl_cq_by_entry: dict) -> dict:
    """entry_idx -> list[Target]; the first feasible problem per entry
    wins (get_targets_internal's fallthrough order)."""
    out: dict = {}
    for bi, p in enumerate(batch.problems):
        ei = p.entry_idx
        if ei in out and out[ei]:
            continue
        if not feasible[bi]:
            out.setdefault(ei, [])
            continue
        preemptor_cq = wl_cq_by_entry[ei]
        domain = p.domain
        targets = []
        k = p.num_candidates
        hit = np.flatnonzero(targets_mask[bi, :k])
        for ki in hit.tolist():
            cand = domain.infos[p.sel[ki]]
            if cand.cluster_queue == preemptor_cq:
                reason = api.IN_CLUSTER_QUEUE_REASON
            elif p.threshold_active and \
                    int(domain.prio[p.sel[ki]]) < p.threshold:
                reason = api.IN_COHORT_RECLAIM_WHILE_BORROWING_REASON
            else:
                reason = api.IN_COHORT_RECLAMATION_REASON
            targets.append(cpu_preempt.Target(cand, reason))
        out[ei] = targets
    return out
