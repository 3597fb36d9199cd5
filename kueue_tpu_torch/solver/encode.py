"""Snapshot -> tensor encoding for the batched admission solver.

Dimensions (padded to the JAX package's bucket sizes, so that both
packages encode the same shapes):
- W: head-of-queue workloads this cycle
- P: pod sets per workload
- R: distinct resource names across all ClusterQueues
- F: distinct flavor names
- Q: ClusterQueues
- C: cohorts

The hierarchical quota tree (reference: pkg/cache/resource_node.go) is
flattened into [Q,F,R] / [C,F,R] integer tensors; taint/affinity
eligibility (string matching) is computed host-side into a [W,P,F] mask
so the device program is pure integer arithmetic.

MultiKueue's remote clusters become [K,F,R] capacity columns of the same
solve (encode_cluster_columns), with the sequential host oracle
place_remote_dicts beside them. The module stays numpy on the host.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.corev1 import RESOURCE_PODS
from kueue_tpu_torch.cache.snapshot import Snapshot
from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.core.resources import FlavorResource
from kueue_tpu_torch.scheduler.flavorassigner import flavor_selector_matches
from kueue_tpu_torch.api.corev1 import find_untolerated_taint

BIG = np.int64(2**62)  # "no limit" encoding

# Eligibility-cache bound: at the cap, the OLDEST half (insertion order)
# is evicted instead of clearing wholesale — a churn-heavy cycle then
# re-primes only cold rows rather than stampeding a full recompute of
# every hot row at once.
ELIG_CACHE_CAP = 65536


def _bucket(n: int, minimum: int = 8, factor: int = 4) -> int:
    """Round up to the next power of `factor`.

    Factor 4 for the per-cycle batch dim W, factor 2 for the topology
    dims (Q, F, R, C): the JAX package's buckets, kept so that both
    packages encode a snapshot to arrays of the same shapes. The kernels
    here compile once per build, not per shape; padding rows are inert
    (solvable=False, podsets inactive)."""
    b = minimum
    while b < n:
        b *= factor
    return b


@dataclass
class Topology:
    """Cycle-stable cluster topology tensors + name<->index maps."""

    resources: list = field(default_factory=list)   # index -> resource name
    flavors: list = field(default_factory=list)     # index -> flavor name
    cq_names: list = field(default_factory=list)    # index -> cq name
    cohort_names: list = field(default_factory=list)

    cq_cohort: np.ndarray = None          # [Q] int32, -1 = no cohort
    nominal: np.ndarray = None            # [Q,F,R] int64
    borrow_limit: np.ndarray = None       # [Q,F,R] int64 (BIG = unlimited)
    guaranteed: np.ndarray = None         # [Q,F,R] int64 (subtree - lending cap)
    offered: np.ndarray = None            # [Q,F,R] bool — (flavor,resource) in CQ
    group_id: np.ndarray = None           # [Q,R] int32, -1 = resource not covered
    flavor_group: np.ndarray = None       # [Q,F] int32, -1 = flavor not in CQ
    flavor_rank: np.ndarray = None        # [Q,F] int32 — order within its group
    covers_pods: np.ndarray = None        # [Q] bool — CQ has a "pods" resource group
    prefer_no_borrow: np.ndarray = None   # [Q] bool — whenCanBorrow == TryNextFlavor
    cohort_subtree: np.ndarray = None     # [C,F,R] int64
    # Hierarchical cohorts (reference: resource_node.go:89-146; the alpha
    # Cohort CRD forms arbitrary-depth trees, cohort_types.go:26-100):
    cohort_parent: np.ndarray = None      # [C] int32, -1 = root
    cohort_depth: np.ndarray = None       # [C] int32, root = 0
    cohort_root: np.ndarray = None        # [C] int32 — root cohort index
    cohort_guaranteed: np.ndarray = None  # [C,F,R] int64 (subtree - lending cap)
    cohort_borrow_limit: np.ndarray = None  # [C,F,R] int64 (BIG = unlimited)
    cq_chain: np.ndarray = None           # [Q,DC] int32 — cohort ancestor chain
                                          #   (direct cohort first; -1 padding)
    # Fair sharing (reference: clusterqueue.go:503-564):
    fair_weight: np.ndarray = None        # [Q] int64 milli-weight
    cohort_lendable: np.ndarray = None    # [C,R] int64 — root tree's lendable
    group_size: np.ndarray = None         # [Q,G] int32 — flavors per group
    cq_index: dict = field(default_factory=dict)
    flavor_index: dict = field(default_factory=dict)
    resource_index: dict = field(default_factory=dict)
    # Monotonic identity for cache invalidation: per-Info encoded rows and
    # the eligibility cache are keyed by this token, so a topology rebuild
    # (new generations / cohort epoch) drops every derived row at once.
    token: int = 0
    elig_cache: dict = field(default_factory=dict)


_TOPO_TOKEN = itertools.count(1)


@dataclass
class State:
    """Per-cycle mutable usage."""

    usage: np.ndarray = None         # [Q,F,R] int64
    cohort_usage: np.ndarray = None  # [C,F,R] int64


@dataclass
class WorkloadBatch:
    infos: list = field(default_factory=list)  # original Info objects (host side)
    n: int = 0                         # real workload count (<= W)
    requests: np.ndarray = None        # [W,P,R] int64
    podset_active: np.ndarray = None   # [W,P] bool
    wl_cq: np.ndarray = None           # [W] int32
    priority: np.ndarray = None        # [W] int64
    timestamp: np.ndarray = None       # [W] float64
    eligible: np.ndarray = None        # [W,P,F] bool (taints/affinity, host-computed)
    solvable: np.ndarray = None        # [W] bool — encodable by the solver
    start_rank: np.ndarray = None      # [W,P,R] int32 — flavor-resume position
                                       #   (LastTriedFlavorIdx + 1; 0 = from start)


def iter_cohorts(snapshot: Snapshot) -> dict:
    """name -> CohortSnapshot for every cohort reachable from any CQ
    (whole trees, including quota-only intermediate nodes)."""
    out: dict = {}

    def visit(c):
        if c.name in out:
            return
        out[c.name] = c
        if c.parent is not None:
            visit(c.parent)
        for child in c.child_cohorts:
            visit(child)

    for cq in snapshot.cluster_queues.values():
        if cq.cohort is not None:
            visit(cq.cohort)
    return out


def encode_topology(snapshot: Snapshot) -> Topology:
    topo = Topology()
    topo.token = next(_TOPO_TOKEN)
    res_set, flavor_set = set(), set()
    for cq in snapshot.cluster_queues.values():
        for rg in cq.resource_groups:
            res_set.update(rg.covered_resources)
            flavor_set.update(rg.flavors)
    topo.resources = sorted(res_set)
    topo.flavors = sorted(flavor_set)
    topo.cq_names = sorted(snapshot.cluster_queues)
    cohort_objs = iter_cohorts(snapshot)
    topo.cohort_names = sorted(cohort_objs)
    topo.resource_index = {r: i for i, r in enumerate(topo.resources)}
    topo.flavor_index = {f: i for i, f in enumerate(topo.flavors)}
    topo.cq_index = {c: i for i, c in enumerate(topo.cq_names)}
    cohort_index = {c: i for i, c in enumerate(topo.cohort_names)}

    Q = _bucket(max(1, len(topo.cq_names)), 1, factor=2)
    F = _bucket(max(1, len(topo.flavors)), 1, factor=2)
    R = _bucket(max(1, len(topo.resources)), 1, factor=2)
    C = _bucket(max(1, len(topo.cohort_names)), 1, factor=2)

    topo.cq_cohort = np.full(Q, -1, np.int32)
    topo.nominal = np.zeros((Q, F, R), np.int64)
    topo.borrow_limit = np.full((Q, F, R), BIG, np.int64)
    topo.guaranteed = np.zeros((Q, F, R), np.int64)
    topo.offered = np.zeros((Q, F, R), bool)
    topo.group_id = np.full((Q, R), -1, np.int32)
    topo.flavor_group = np.full((Q, F), -1, np.int32)
    topo.flavor_rank = np.full((Q, F), 10**6, np.int32)
    topo.covers_pods = np.zeros(Q, bool)
    topo.prefer_no_borrow = np.zeros(Q, bool)
    topo.cohort_subtree = np.zeros((C, F, R), np.int64)
    topo.cohort_parent = np.full(C, -1, np.int32)
    topo.cohort_depth = np.zeros(C, np.int32)
    topo.cohort_root = np.arange(C, dtype=np.int32)
    topo.cohort_guaranteed = np.zeros((C, F, R), np.int64)
    topo.cohort_borrow_limit = np.full((C, F, R), BIG, np.int64)
    topo.fair_weight = np.full(Q, 1000, np.int64)
    topo.cohort_lendable = np.zeros((C, R), np.int64)

    for cname, cobj in cohort_objs.items():
        ci = cohort_index[cname]
        if cobj.parent is not None:
            topo.cohort_parent[ci] = cohort_index[cobj.parent.name]
        rn = cobj.resource_node
        for fr, q in rn.subtree_quota.items():
            fi = topo.flavor_index.get(fr.flavor)
            ri = topo.resource_index.get(fr.resource)
            if fi is not None and ri is not None:
                topo.cohort_subtree[ci, fi, ri] = q
                topo.cohort_guaranteed[ci, fi, ri] = rn.guaranteed_quota(fr)
        for fr, quota in rn.quotas.items():
            fi = topo.flavor_index.get(fr.flavor)
            ri = topo.resource_index.get(fr.resource)
            if fi is not None and ri is not None and quota.borrowing_limit is not None:
                topo.cohort_borrow_limit[ci, fi, ri] = quota.borrowing_limit
    # depth + root by chasing parents (trees are cycle-checked upstream)
    lendable_by_root: dict = {}
    for cname in topo.cohort_names:
        ci = cohort_index[cname]
        depth, node = 0, cohort_objs[cname]
        while node.parent is not None:
            depth += 1
            node = node.parent
        topo.cohort_depth[ci] = depth
        topo.cohort_root[ci] = cohort_index[node.name]
        # DRF denominator: the root tree's lendable capacity per resource
        # (host-computed so flavors outside this topology still count;
        # only root rows are read by the kernel).
        if node.name not in lendable_by_root:
            lendable_by_root[node.name] = node.resource_node.calculate_lendable()
        if cname == node.name:
            for rname, q in lendable_by_root[node.name].items():
                ri = topo.resource_index.get(rname)
                if ri is not None:
                    topo.cohort_lendable[ci, ri] = q
    # per-CQ ancestor chain, direct cohort first (static max depth)
    max_chain = 1
    for cq in snapshot.cluster_queues.values():
        if cq.cohort is not None:
            max_chain = max(max_chain,
                            int(topo.cohort_depth[cohort_index[cq.cohort.name]]) + 1)
    topo.cq_chain = np.full((Q, max_chain), -1, np.int32)

    for qname, cq in snapshot.cluster_queues.items():
        qi = topo.cq_index[qname]
        if cq.cohort is not None:
            topo.cq_cohort[qi] = cohort_index[cq.cohort.name]
            node, d = cq.cohort, 0
            while node is not None:
                topo.cq_chain[qi, d] = cohort_index[node.name]
                node, d = node.parent, d + 1
        topo.prefer_no_borrow[qi] = (cq.flavor_fungibility.when_can_borrow
                                     == api.TRY_NEXT_FLAVOR)
        topo.fair_weight[qi] = cq.fair_weight
        for gi, rg in enumerate(cq.resource_groups):
            for r in rg.covered_resources:
                if r == RESOURCE_PODS:
                    topo.covers_pods[qi] = True
                topo.group_id[qi, topo.resource_index[r]] = gi
            for rank, fname in enumerate(rg.flavors):
                fi = topo.flavor_index[fname]
                topo.flavor_group[qi, fi] = gi
                topo.flavor_rank[qi, fi] = rank
                for r in rg.covered_resources:
                    ri = topo.resource_index[r]
                    fr = FlavorResource(fname, r)
                    quota = cq.quota_for(fr)
                    topo.offered[qi, fi, ri] = True
                    topo.nominal[qi, fi, ri] = quota.nominal
                    if quota.borrowing_limit is not None:
                        topo.borrow_limit[qi, fi, ri] = quota.borrowing_limit
                    topo.guaranteed[qi, fi, ri] = cq.resource_node.guaranteed_quota(fr)
    # flavors per resource group (decode needs it for LastTriedFlavorIdx
    # exhaustion; vectorized over all admitted rows)
    max_groups = max((len(cq.resource_groups)
                      for cq in snapshot.cluster_queues.values()), default=1)
    topo.group_size = np.zeros((Q, max(1, max_groups)), np.int32)
    for qname, cq in snapshot.cluster_queues.items():
        qi = topo.cq_index[qname]
        for gi, rg in enumerate(cq.resource_groups):
            topo.group_size[qi, gi] = len(rg.flavors)
    return topo


def encode_state(snapshot: Snapshot, topo: Topology) -> State:
    Q, F, R = topo.nominal.shape
    C = topo.cohort_subtree.shape[0]
    state = State(usage=np.zeros((Q, F, R), np.int64),
                  cohort_usage=np.zeros((C, F, R), np.int64))
    cohort_index = {c: i for i, c in enumerate(topo.cohort_names)}
    for qname, cq in snapshot.cluster_queues.items():
        qi = topo.cq_index[qname]
        for fr, used in cq.resource_node.usage.items():
            fi = topo.flavor_index.get(fr.flavor)
            ri = topo.resource_index.get(fr.resource)
            if fi is not None and ri is not None:
                state.usage[qi, fi, ri] = used
    for cname, cobj in iter_cohorts(snapshot).items():
        ci = cohort_index.get(cname)
        if ci is None:
            continue
        for fr, used in cobj.resource_node.usage.items():
            fi = topo.flavor_index.get(fr.flavor)
            ri = topo.resource_index.get(fr.resource)
            if fi is not None and ri is not None:
                state.cohort_usage[ci, fi, ri] = used
    return state


def _encode_one(info, snapshot: Snapshot, topo: Topology, P: int):
    """Encode one workload's cycle-stable rows. Returns
    (qi, requests [P,R], active [P], eligible [P,F], solvable) — or
    qi == -1 when the CQ is unknown. Cached on the Info keyed by
    topo.token (Info.total_requests is fixed at Info construction; the
    queue manager builds a fresh Info on workload updates)."""
    cq = snapshot.cluster_queues.get(info.cluster_queue)
    if cq is None:
        return -1, None, None, None, False
    qi = topo.cq_index[info.cluster_queue]
    _, F, R = topo.nominal.shape
    requests = np.zeros((P, R), np.int64)
    active = np.zeros(P, bool)
    eligible = np.zeros((P, F), bool)
    if len(info.total_requests) > P:
        return qi, requests, active, eligible, False  # CPU fallback
    resource_index = topo.resource_index
    covers_pods = topo.covers_pods[qi]
    for pi, psr in enumerate(info.total_requests):
        reqs = dict(psr.requests)
        if covers_pods:
            reqs[RESOURCE_PODS] = psr.count
        for r, v in reqs.items():
            ri = resource_index.get(r)
            if ri is None or topo.group_id[qi, ri] < 0:
                return qi, requests, active, eligible, False
            requests[pi, ri] = v
        active[pi] = True
        eligible[pi] = eligibility_row(info, pi, qi, cq, snapshot, topo)
    return qi, requests, active, eligible, True


def eligibility_row(info, pi: int, qi: int, cq, snapshot: Snapshot,
                    topo: Topology) -> np.ndarray:
    """Host-side taints/affinity per flavor for one podset, memoized by
    pod-spec signature: identical pod shapes (the common case at scale)
    share one eligibility row instead of re-running the string-matching
    loop per workload. Shared by the oracle and the encode arena."""
    pod_spec = info.obj.spec.pod_sets[pi].template.spec
    key = (qi, _eligibility_key(pod_spec))
    row = topo.elig_cache.get(key)
    if row is not None:
        # Move-to-end on hit: the oldest-half eviction then drops the
        # LEAST-RECENTLY-USED half, so a permanently-hot shared row
        # (the dominant pod shape) survives every cap trip. Row encodes
        # are already O(changed), so the two dict ops are noise.
        del topo.elig_cache[key]
        topo.elig_cache[key] = row
        return row
    if len(topo.elig_cache) >= ELIG_CACHE_CAP:
        _evict_oldest_half(topo.elig_cache)
    F = topo.nominal.shape[1]
    row = np.zeros(F, bool)
    for rg in cq.resource_groups:
        for fname in rg.flavors:
            flavor = snapshot.resource_flavors.get(fname)
            if flavor is None:
                continue
            if find_untolerated_taint(flavor.spec.node_taints,
                                      pod_spec.tolerations) is not None:
                continue
            if not flavor_selector_matches(pod_spec, rg.label_keys,
                                           flavor.spec.node_labels):
                continue
            row[topo.flavor_index[fname]] = True
    topo.elig_cache[key] = row
    return row


def _evict_oldest_half(cache: dict) -> None:
    """Bound growth under per-workload-unique pod shapes. dicts preserve
    insertion order and eligibility_row moves entries to the end on
    every hit, so the first half is the least recently used."""
    for k in list(itertools.islice(cache, len(cache) // 2)):
        del cache[k]


def fill_start_ranks(start_rank: np.ndarray, entries: list, solvable,
                     snapshot: Snapshot, topo: Topology, P: int) -> None:
    """Flavor-fungibility resume positions for the batch (reference:
    flavorassigner.go:289-296) — the one genuinely per-cycle encode
    input (capacity generations move between cycles). Shared by the
    from-scratch oracle and the arena assembler.

    Writes only the stored (podset, resource) entries instead of the old
    per-workload P x R double loop: absent resources and podsets resolve
    to next_flavor_to_try == 0, the array default, so the output is
    bit-identical. The outdated-generation check clears
    info.last_assignment exactly like the sequential assigner."""
    import operator
    gen_cache: dict = {}
    resource_index = topo.resource_index
    cqs = snapshot.cluster_queues
    # C-level attribute walk: most heads have no resume state, and the
    # per-entry getattr loop was measurable at 2048 heads.
    las = map(operator.attrgetter("last_assignment"), entries)
    for wi, la in enumerate(las):
        if la is None or not solvable[wi]:
            continue
        info = entries[wi]
        gens = gen_cache.get(info.cluster_queue)
        if gens is None:
            cq = cqs[info.cluster_queue]
            gens = (cq.allocatable_resource_generation,
                    cq.cohort.allocatable_resource_generation
                    if cq.cohort is not None else None)
            gen_cache[info.cluster_queue] = gens
        if gens[0] > la.cluster_queue_generation \
                or (gens[1] is not None and gens[1] > la.cohort_generation):
            info.last_assignment = None  # capacity moved: restart from 0
            continue
        n_ps = min(len(info.total_requests), P)
        for pi, tried in enumerate(la.last_tried_flavor_idx[:n_ps]):
            for r, idx in tried.items():
                ri = resource_index.get(r)
                if ri is not None and idx >= 0:
                    start_rank[wi, pi, ri] = idx + 1


def encode_workloads(entries: list, snapshot: Snapshot, topo: Topology,
                     ordering: Optional[wlpkg.Ordering] = None,
                     max_podsets: int = 4) -> WorkloadBatch:
    """entries: list of workload Info heads."""
    ordering = ordering or wlpkg.Ordering()
    W = _bucket(max(1, len(entries)))
    P = max_podsets
    _, F, R = topo.nominal.shape

    batch = WorkloadBatch(infos=list(entries), n=len(entries))
    batch.requests = np.zeros((W, P, R), np.int64)
    batch.podset_active = np.zeros((W, P), bool)
    batch.wl_cq = np.zeros(W, np.int32)
    batch.priority = np.zeros(W, np.int64)
    batch.timestamp = np.zeros(W, np.float64)
    batch.eligible = np.zeros((W, P, F), bool)
    batch.solvable = np.zeros(W, bool)
    batch.start_rank = np.zeros((W, P, R), np.int32)

    token = topo.token
    priorities, timestamps = batch.priority, batch.timestamp
    for wi, info in enumerate(entries):
        # Keyed by (topology token, resourceVersion): a workload update
        # that rebuilds requests without a fresh Info (e.g. reclaimable
        # pods) must invalidate the cached rows too.
        key = (token, info.obj.metadata.resource_version)
        enc = getattr(info, "_solver_enc", None)
        if enc is None or enc[0] != key:
            enc = (key,) + _encode_one(info, snapshot, topo, P)
            info._solver_enc = enc
        _, qi, requests, active, eligible, ok = enc
        if qi < 0:
            continue
        batch.wl_cq[wi] = qi
        priorities[wi] = prioritypkg.priority(info.obj)
        timestamps[wi] = ordering.queue_order_timestamp(info.obj)
        if not ok:
            continue
        batch.requests[wi] = requests
        batch.podset_active[wi] = active
        batch.eligible[wi] = eligible
        batch.solvable[wi] = True
    # Flavor-fungibility resume: both the outdated check and the resume
    # apply regardless of the FlavorFungibility gate, mirroring the CPU
    # assigner.
    fill_start_ranks(batch.start_rank, entries, batch.solvable, snapshot,
                     topo, P)
    return batch


# ---------------------------------------------------------------------------
# MultiKueue remote clusters as flavor-capacity columns
# ---------------------------------------------------------------------------
#
# The port of kueue_tpu/solver/encode.py:486-622. Snapshot.remote_clusters
# carries each worker cluster's available capacity as {(flavor, resource):
# quantity}; the encoder folds it into [K,F,R] tensors in the LOCAL
# topology's flavor and resource index space (capacity on a flavor or a
# resource unknown locally cannot be scored and is ignored).
# kernel.score_cluster_columns scores the columns inside the fused solve;
# place_remote_dicts is the sequential host oracle with the same
# placement rule, which the Scheduler runs for the rows the device did
# not place.


@dataclass
class ClusterColumns:
    """Encoded remote-cluster capacity columns for one cycle."""

    names: tuple = ()                 # K_real cluster names, column order
    ccap: np.ndarray = None           # [K,F,R] int64 available capacity
    coffer: np.ndarray = None         # [K,F,R] bool: (f,r) offered
    cactive: np.ndarray = None        # [K] bool: reachable
    mk_cq: np.ndarray = None          # [Q] bool: CQ has a MultiKueue check


def encode_cluster_columns(snapshot: Snapshot,
                           topo: Topology) -> Optional[ClusterColumns]:
    """Snapshot remote-cluster capacities -> column tensors, or None when
    the snapshot carries no remote clusters or no CQ carries a MultiKueue
    check. K is bucketed (factor 2, like the other topology dims);
    padding columns are inactive and offer nothing. Capacity is clamped
    at 0."""
    remotes = snapshot.remote_clusters
    if not remotes:
        return None
    Q, F, R = topo.nominal.shape
    K = _bucket(len(remotes), 1, factor=2)
    cols = ClusterColumns(names=tuple(name for name, _, _ in remotes))
    cols.ccap = np.zeros((K, F, R), np.int64)
    cols.coffer = np.zeros((K, F, R), bool)
    cols.cactive = np.zeros(K, bool)
    for ki, (_name, caps, active) in enumerate(remotes):
        cols.cactive[ki] = bool(active)
        for (fname, rname), avail in caps.items():
            fi = topo.flavor_index.get(fname)
            ri = topo.resource_index.get(rname)
            if fi is None or ri is None:
                continue
            cols.coffer[ki, fi, ri] = True
            cols.ccap[ki, fi, ri] = max(int(avail), 0)
    mk_checks = snapshot.mk_check_names
    cols.mk_cq = np.zeros(Q, bool)
    if mk_checks:
        for qname, cq in snapshot.cluster_queues.items():
            if not mk_checks.isdisjoint(cq.admission_checks):
                cols.mk_cq[topo.cq_index[qname]] = True
    if not cols.mk_cq.any():
        return None  # no CQ routes through the columns this cycle
    return cols


def cluster_args_device(cols: ClusterColumns) -> tuple:
    """The kernel-facing (ccap, coffer, cactive, mk_cq) tuple."""
    return (cols.ccap, cols.coffer, cols.cactive, cols.mk_cq)


def consume_remote_dicts(remote_clusters: tuple, requests: list,
                         pinned: list) -> tuple:
    """Debit already-decided (pinned) placements from the capacity columns
    and return the REMAINING columns tuple: a capacity source prices
    placements the remote has not reserved yet with it, so consecutive
    cycles do not place again onto capacity the remote read cannot see."""
    remaining = [dict(caps) for _, caps, _ in remote_clusters]
    by_name = {c[0]: i for i, c in enumerate(remote_clusters)}
    for req, cluster in zip(requests, pinned):
        ki = by_name.get(cluster)
        if ki is None:
            continue
        caps = remaining[ki]
        flavors: dict = {}
        for (fname, rname), avail in caps.items():
            flavors.setdefault(fname, {})[rname] = avail
        req = {r: v for r, v in req.items() if v > 0}
        for fname in sorted(flavors):
            rem = flavors[fname]
            if all(r in rem and rem[r] >= v for r, v in req.items()) \
                    and any(r in rem for r in req):
                for r, v in req.items():
                    caps[(fname, r)] -= v
                break
    return tuple((name, remaining[i], active)
                 for i, (name, _caps, active) in enumerate(remote_clusters))


def place_remote_dicts(remote_clusters: tuple, requests: list,
                       pinned: Optional[list] = None) -> list:
    """The sequential placement oracle in name space: for each
    per-workload request dict {resource: quantity} (in admission order),
    pick the FIRST active cluster (column order) with ONE flavor whose
    remaining capacity covers every requested resource, and consume it.
    ``pinned[i]`` (a cluster name) forces workload i's choice: the
    Scheduler pins the rows the device placed, so the host continuation
    accounts from the same remaining capacity. Returns a cluster name or
    None per workload. kernel.score_cluster_columns is its batched twin."""
    remaining = []
    for name, caps, active in remote_clusters:
        flavors: dict = {}
        for (fname, rname), avail in caps.items():
            flavors.setdefault(fname, {})[rname] = max(int(avail), 0)
        remaining.append((name, flavors, bool(active)))
    out: list = []

    def fit_flavor(flavors: dict, req: dict) -> Optional[str]:
        # sorted: the kernel scans flavors in topology index order, which
        # encode_topology builds from sorted names; the oracle must
        # consume the same flavor or later placements would diverge.
        for fname in sorted(flavors):
            rem = flavors[fname]
            if all(r in rem and rem[r] >= v for r, v in req.items() if v > 0):
                if any(r in rem for r, v in req.items() if v > 0):
                    return fname
        return None

    for i, req in enumerate(requests):
        req = {r: v for r, v in req.items() if v > 0}
        chosen = None
        want = pinned[i] if pinned is not None else None
        for name, flavors, active in remaining:
            if not active or not req:
                continue
            if want is not None and name != want:
                continue
            f = fit_flavor(flavors, req)
            if f is not None:
                chosen = name
                for r, v in req.items():
                    flavors[f][r] -= v
                break
            if want is not None:
                # Pinned but no longer fits on the host: honor the pin
                # anyway (the device already consumed this capacity in
                # its own accounting) without debiting twice.
                chosen = name
                break
        if chosen is None and want is not None:
            chosen = want  # pinned to a cluster outside the column set
        out.append(chosen)
    return out


# ---------------------------------------------------------------------------
# Device-resident state: sparse correction encoding + the host mirror
# ---------------------------------------------------------------------------

def encode_deltas(corrections: dict, topo: Topology):
    """corrections: {(cq_name, FlavorResource) -> net delta}. Returns the
    (dq, df, dr, dv, lvl_c, lvl_seg) tuple for kernel.apply_state_deltas,
    or None when nothing maps onto the topology. Coords are unique per
    level by construction (aggregation dict + np.unique)."""
    coords = []
    for (cq_name, fr), dv in corrections.items():
        if dv == 0:
            continue
        qi = topo.cq_index.get(cq_name)
        fi = topo.flavor_index.get(fr.flavor)
        ri = topo.resource_index.get(fr.resource)
        if qi is None or fi is None or ri is None:
            continue
        coords.append((qi, fi, ri, dv))
    if not coords:
        return None
    return deltas_from_coords(coords, topo.cq_chain, topo.cohort_parent)


def deltas_from_coords(coords: list, cq_chain: np.ndarray,
                       cohort_parent: np.ndarray) -> tuple:
    """Unique (q, f, r, delta) coords -> the padded delta tuple: [D]
    coords (D bucketed from 8 by 4, dq = -1 on padding), then per chain
    level the unique cohort coords lvl_c[L,D,3] and lvl_seg[L,D], which
    maps row d of the level below (level 0: the delta coords) to its
    cohort coord's row (-1 = chain ends or padding)."""
    D = _bucket(len(coords), 8)
    dq = np.full(D, -1, np.int32)
    df = np.zeros(D, np.int32)
    dr = np.zeros(D, np.int32)
    dv = np.zeros(D, np.int64)
    arr = np.asarray(coords, np.int64)
    n = len(coords)
    dq[:n] = arr[:, 0]
    df[:n] = arr[:, 1]
    dr[:n] = arr[:, 2]
    dv[:n] = arr[:, 3]

    L = cq_chain.shape[1]
    lvl_c = np.full((L, D, 3), -1, np.int32)
    lvl_seg = np.full((L, D), -1, np.int32)
    # level 0 parents: the delta coords' direct cohorts; level l parents:
    # level l-1's cohort coords' parents. Dedup per level with np.unique.
    prev_c = np.where(dq >= 0, cq_chain[np.maximum(dq, 0), 0], -1)  # [D]
    prev_f, prev_r = df, dr
    for lvl in range(L):
        valid = prev_c >= 0
        if not valid.any():
            break
        key = (prev_c.astype(np.int64) << 32) | \
              (prev_f.astype(np.int64) << 16) | prev_r.astype(np.int64)
        key = np.where(valid, key, np.int64(-1))
        uniq, inv = np.unique(key, return_inverse=True)
        off = 1 if uniq[0] == -1 else 0  # drop the invalid bucket
        m = len(uniq) - off
        lvl_c[lvl, :m, 0] = (uniq[off:] >> 32).astype(np.int32)
        lvl_c[lvl, :m, 1] = ((uniq[off:] >> 16) & 0xFFFF).astype(np.int32)
        lvl_c[lvl, :m, 2] = (uniq[off:] & 0xFFFF).astype(np.int32)
        lvl_seg[lvl] = np.where(valid, inv - off, -1).astype(np.int32)
        # next level: parents of this level's unique cohorts
        prev_c = np.full(D, -1, np.int32)
        prev_c[:m] = cohort_parent[lvl_c[lvl, :m, 0]]
        prev_f = np.maximum(lvl_c[lvl, :, 1], 0)
        prev_r = np.maximum(lvl_c[lvl, :, 2], 0)
    return dq, df, dr, dv, lvl_c, lvl_seg


def apply_deltas_np(topo: Topology, usage: np.ndarray,
                    cohort_usage: np.ndarray, deltas) -> None:
    """In-place numpy twin of kernel.apply_state_deltas — keeps the host
    mirror bit-identical to the device-resident state."""
    dq, df, dr, dv, lvl_c, lvl_seg = deltas
    valid = dq >= 0
    dqs = np.maximum(dq, 0)
    dvm = np.where(valid, dv, 0)
    old = usage[dqs, df, dr].copy()
    np.add.at(usage, (dqs, df, dr), dvm)
    g = topo.guaranteed[dqs, df, dr]
    dover = np.maximum(0, old + dvm - g) - np.maximum(0, old - g)
    D = len(dq)
    for lvl in range(lvl_c.shape[0]):
        seg = lvl_seg[lvl]
        delta_l = np.zeros(D, np.int64)
        np.add.at(delta_l, np.maximum(seg, 0), np.where(seg >= 0, dover, 0))
        c = lvl_c[lvl, :, 0]
        cvalid = c >= 0
        if not cvalid.any():
            break
        cs = np.maximum(c, 0)
        fs = np.maximum(lvl_c[lvl, :, 1], 0)
        rs = np.maximum(lvl_c[lvl, :, 2], 0)
        delta_l = np.where(cvalid, delta_l, 0)
        oldc = cohort_usage[cs, fs, rs].copy()
        np.add.at(cohort_usage, (cs, fs, rs), delta_l)
        gc = topo.cohort_guaranteed[cs, fs, rs]
        dover = np.maximum(0, oldc + delta_l - gc) - np.maximum(0, oldc - gc)


def _eligibility_key(pod_spec) -> tuple:
    """Hashable signature of the pod-spec fields that feed flavor
    eligibility (tolerations, node selector, node affinity)."""
    tols = tuple((t.key, t.operator, t.value, t.effect)
                 for t in pod_spec.tolerations)
    sel = tuple(sorted(pod_spec.node_selector.items()))
    aff = ()
    if pod_spec.affinity is not None and pod_spec.affinity.node_affinity is not None:
        req = pod_spec.affinity.node_affinity.required
        if req is not None:
            aff = tuple(
                tuple((e.key, e.operator, tuple(e.values))
                      for e in term.match_expressions)
                for term in req.node_selector_terms)
    return tols, sel, aff
