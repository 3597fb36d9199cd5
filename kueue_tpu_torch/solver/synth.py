"""Synthetic solver inputs for the kernel phases of chip_smoke.py and the
parity tests.

Builds solver input arrays (numpy) for a parameterized cluster shape without
going through the Python object model (the object path is exercised by
tests; this measures the device program at scale).
"""

from __future__ import annotations

import numpy as np

from kueue_tpu_torch.solver.encode import deltas_from_coords, place_remote_dicts


def synth_solver_inputs(num_cqs: int = 256, num_cohorts: int = 32,
                        num_flavors: int = 8, num_resources: int = 2,
                        num_workloads: int = 256, num_podsets: int = 1,
                        seed: int = 0):
    """Returns (topo dict of np arrays, usage, cohort_usage, workload arrays)
    shaped like encode.py's output: one resource group per CQ covering all
    resources with all flavors in order."""
    rng = np.random.default_rng(seed)
    Q, F, R, C, W, P = (num_cqs, num_flavors, num_resources, num_cohorts,
                        num_workloads, num_podsets)

    nominal_units = rng.integers(10, 50, size=(Q, F, R)).astype(np.int64) * 1000
    topo = {
        "cq_cohort": (np.arange(Q) % C).astype(np.int32),
        "nominal": nominal_units,
        "borrow_limit": np.full((Q, F, R), 2**62, np.int64),
        "guaranteed": np.zeros((Q, F, R), np.int64),
        "offered": np.ones((Q, F, R), bool),
        "group_id": np.zeros((Q, R), np.int32),
        "flavor_group": np.zeros((Q, F), np.int32),
        "flavor_rank": np.tile(np.arange(F, dtype=np.int32), (Q, 1)),
        "prefer_no_borrow": np.zeros(Q, bool),
        "cohort_subtree": np.zeros((C, F, R), np.int64),
        # flat (single-level) cohort forest
        "cohort_parent": np.full(C, -1, np.int32),
        "cohort_depth": np.zeros(C, np.int32),
        "cohort_root": np.arange(C, dtype=np.int32),
        "cohort_guaranteed": np.zeros((C, F, R), np.int64),
        "cohort_borrow_limit": np.full((C, F, R), 2**62, np.int64),
        "cq_chain": (np.arange(Q) % C).astype(np.int32).reshape(Q, 1),
        "fair_weight": np.full(Q, 1000, np.int64),
        "cohort_lendable": np.zeros((C, R), np.int64),
    }
    for c in range(C):
        members = topo["cq_cohort"] == c
        topo["cohort_subtree"][c] = nominal_units[members].sum(axis=0)
        topo["cohort_lendable"][c] = topo["cohort_subtree"][c].sum(axis=0)

    usage = (nominal_units * rng.uniform(0, 0.5, size=(Q, F, R))).astype(np.int64)
    cohort_usage = np.zeros((C, F, R), np.int64)
    for c in range(C):
        members = topo["cq_cohort"] == c
        cohort_usage[c] = np.maximum(0, usage[members] - topo["guaranteed"][members]).sum(axis=0)

    wl = {
        "requests": np.zeros((W, P, R), np.int64),
        "podset_active": np.zeros((W, P), bool),
        "wl_cq": rng.integers(0, Q, size=W).astype(np.int32),
        "priority": rng.integers(0, 100, size=W).astype(np.int64),
        "timestamp": rng.uniform(0, 1e6, size=W),
        "eligible": np.ones((W, P, F), bool),
        "solvable": np.ones(W, bool),
    }
    for p in range(P):
        active = rng.uniform(size=W) < (1.0 if p == 0 else 0.3)
        wl["podset_active"][:, p] = active
        wl["requests"][:, p, :] = np.where(
            active[:, None],
            rng.integers(1, 20, size=(W, R)) * 1000, 0)
    # Randomly restrict some eligibility (taints/affinity analogue).
    wl["eligible"] &= rng.uniform(size=(W, P, F)) < 0.9
    return topo, usage, cohort_usage, wl


def synth_nested_inputs(num_cqs: int = 64, num_leaf_cohorts: int = 8,
                        fanout: int = 2, depth: int = 3,
                        num_flavors: int = 8, num_resources: int = 2,
                        num_workloads: int = 64, num_podsets: int = 3,
                        no_cohort_every: int = 0, attach_up_every: int = 0,
                        seed: int = 0):
    """Like synth_solver_inputs, with cohort trees `depth` levels deep
    (leaf cohorts first, `fanout` children per parent), lending and
    borrowing limits on some CQs and cohorts, TryNextFlavor on some CQs,
    every `no_cohort_every`-th CQ outside any cohort and every
    `attach_up_every`-th CQ (from CQ 1) attached to its leaf cohort's
    parent instead (0 = none), so that a node is shared by CQs at two
    depths.
    Subtree quotas, guaranteed quotas and cohort usage follow the quota
    tree's rules (resource_node.go): a node's subtree is its children's
    subtree minus what they keep guaranteed, and usage bubbles past each
    level's guaranteed quota."""
    topo, usage, _, wl = synth_solver_inputs(
        num_cqs=num_cqs, num_cohorts=num_leaf_cohorts,
        num_flavors=num_flavors, num_resources=num_resources,
        num_workloads=num_workloads, num_podsets=num_podsets, seed=seed)
    rng = np.random.default_rng(seed + 1)
    Q, F, R = usage.shape
    big = np.int64(2**62)
    sizes = [num_leaf_cohorts]
    for _ in range(depth - 1):
        sizes.append(max(1, -(-sizes[-1] // fanout)))
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    C = int(starts[-1])
    parent = np.full(C, -1, np.int32)
    level = np.zeros(C, np.int32)
    for lvl in range(depth):
        level[starts[lvl]:starts[lvl + 1]] = lvl
        if lvl + 1 < depth:
            for i in range(sizes[lvl]):
                parent[starts[lvl] + i] = starts[lvl + 1] + i // fanout
    cohort_depth = (depth - 1 - level).astype(np.int32)
    root = np.arange(C, dtype=np.int32)
    for c in range(C):
        while parent[root[c]] >= 0:
            root[c] = parent[root[c]]

    cq_cohort = topo["cq_cohort"].copy()
    if no_cohort_every:
        cq_cohort[::no_cohort_every] = -1
    if attach_up_every:
        for q in range(1, Q, attach_up_every):
            if cq_cohort[q] >= 0 and parent[cq_cohort[q]] >= 0:
                cq_cohort[q] = parent[cq_cohort[q]]
    nominal = topo["nominal"]
    guaranteed = np.where(rng.uniform(size=(Q, F, R)) < 0.3, nominal // 4,
                          0).astype(np.int64)
    borrow_limit = np.where(rng.uniform(size=(Q, F, R)) < 0.3, nominal // 2,
                            big).astype(np.int64)
    borrow_limit[cq_cohort < 0] = big

    subtree = np.zeros((C, F, R), np.int64)
    cguar = np.zeros((C, F, R), np.int64)
    cbl = np.full((C, F, R), big, np.int64)
    cusage = np.zeros((C, F, R), np.int64)
    for q in range(Q):
        c = cq_cohort[q]
        if c >= 0:
            subtree[c] += nominal[q] - guaranteed[q]
            cusage[c] += np.maximum(0, usage[q] - guaranteed[q])
    for c in range(C):  # children precede parents in index order
        if parent[c] < 0:
            continue
        cguar[c] = np.where(rng.uniform(size=(F, R)) < 0.3, subtree[c] // 4, 0)
        cbl[c] = np.where(rng.uniform(size=(F, R)) < 0.3, subtree[c] // 2, big)
        subtree[parent[c]] += subtree[c] - cguar[c]
        cusage[parent[c]] += np.maximum(0, cusage[c] - cguar[c])

    chain = np.full((Q, depth), -1, np.int32)
    for q in range(Q):
        c, d = cq_cohort[q], 0
        while c >= 0:
            chain[q, d] = c
            c, d = parent[c], d + 1
    lendable = np.zeros((C, R), np.int64)
    roots = parent < 0
    lendable[roots] = subtree[roots].sum(axis=1)
    topo.update({
        "cq_cohort": cq_cohort, "guaranteed": guaranteed,
        "borrow_limit": borrow_limit,
        "prefer_no_borrow": rng.uniform(size=Q) < 0.3,
        "cohort_subtree": subtree, "cohort_parent": parent,
        "cohort_depth": cohort_depth, "cohort_root": root,
        "cohort_guaranteed": cguar, "cohort_borrow_limit": cbl,
        "cq_chain": chain, "cohort_lendable": lendable,
    })
    return topo, usage, cusage, wl


def synth_deltas(topo: dict, usage: np.ndarray, num_coords: int,
                 seed: int = 0) -> tuple:
    """A delta prologue for kernel.apply_state_deltas: `num_coords`
    unique (q, f, r) coords with net deltas that keep usage non-negative
    (finishes free at most what is used, admissions add up to nominal),
    encoded as encode.encode_deltas encodes the journal's corrections."""
    rng = np.random.default_rng(seed + 3)
    Q, F, R = usage.shape
    pick = rng.choice(Q * F * R, size=min(num_coords, Q * F * R),
                      replace=False)
    coords = []
    for q, f, r in zip(*np.unravel_index(pick, (Q, F, R))):
        lo, hi = -int(usage[q, f, r]), int(topo["nominal"][q, f, r])
        coords.append((int(q), int(f), int(r),
                       int(rng.integers(lo, hi + 1)) or 1000))
    return deltas_from_coords(coords, topo["cq_chain"], topo["cohort_parent"])


def synth_start_rank(wl: dict, num_flavors: int, seed: int = 0) -> np.ndarray:
    """A flavor-resume position for about a third of the (workload,
    podset, resource) slots: start_rank [W,P,R] int32."""
    rng = np.random.default_rng(seed + 2)
    shape = wl["requests"].shape
    return np.where(rng.uniform(size=shape) < 0.3,
                    rng.integers(0, num_flavors, size=shape), 0).astype(np.int32)


def synth_preempt_inputs(num_problems: int, max_candidates: int,
                         max_local_cqs: int = 4, depth: int = 3,
                         num_cqs: int = 64, num_leaf_cohorts: int = 8,
                         fanout: int = 2, num_flavors: int = 4,
                         num_resources: int = 2, table_rows: int = 64,
                         seed: int = 0):
    """Synthetic minimal-preemption problems for kernel.solve_preempt on a
    synthetic cluster: returns (topo dict, usage, cohort_usage,
    preempt_args). The cluster is synth_nested_inputs' (depth 1 is a
    flat cohort forest) with every 5th CQ attached one level up (a node
    shared by CQs at two depths), every 8th outside any cohort, and usage
    between 30% and 140% of nominal, bubbled up the tree past each
    level's guaranteed quota; the problems are synth_preempt_problems'."""
    topo, usage, cusage = synth_preempt_cluster(
        depth, num_cqs, num_leaf_cohorts, fanout, num_flavors,
        num_resources, seed)
    from kueue_tpu_torch.solver.preempt import preempt_args
    batch = synth_preempt_problems(topo, num_problems, max_candidates,
                                   max_local_cqs, table_rows, seed + 200)
    return topo, usage, cusage, preempt_args(batch)


def synth_preempt_cluster(depth: int, num_cqs: int, num_leaf_cohorts: int,
                          fanout: int, num_flavors: int, num_resources: int,
                          seed: int):
    """The cluster of synth_preempt_inputs: (topo dict, usage,
    cohort_usage)."""
    if depth > 1:
        topo, _, _, _ = synth_nested_inputs(
            num_cqs=num_cqs, num_leaf_cohorts=num_leaf_cohorts,
            fanout=fanout, depth=depth, num_flavors=num_flavors,
            num_resources=num_resources, num_workloads=8, num_podsets=1,
            no_cohort_every=8, attach_up_every=5, seed=seed)
    else:
        topo, _, _, _ = synth_solver_inputs(
            num_cqs=num_cqs, num_cohorts=num_leaf_cohorts,
            num_flavors=num_flavors, num_resources=num_resources,
            num_workloads=8, seed=seed)
        topo["cq_cohort"][::8] = -1
        topo["cq_chain"][::8] = -1
    rng = np.random.default_rng(seed + 100)
    nominal, guar = topo["nominal"], topo["guaranteed"]
    Q, F, R = nominal.shape
    C = topo["cohort_subtree"].shape[0]
    usage = (nominal * rng.uniform(0.3, 1.4, size=(Q, F, R))).astype(np.int64)
    parent = topo["cohort_parent"]
    cusage = np.zeros((C, F, R), np.int64)
    for q in range(Q):
        if topo["cq_cohort"][q] >= 0:
            cusage[topo["cq_cohort"][q]] += np.maximum(0, usage[q] - guar[q])
    for c in range(C):  # children precede parents in index order
        if parent[c] >= 0:
            cusage[parent[c]] += np.maximum(
                0, cusage[c] - topo["cohort_guaranteed"][c])
    return topo, usage, cusage


def synth_fair_inputs(num_problems: int, max_candidates: int,
                      max_local_cqs: int = 4, depth: int = 3,
                      num_cqs: int = 64, num_leaf_cohorts: int = 8,
                      fanout: int = 2, num_flavors: int = 4,
                      num_resources: int = 2, table_rows: int = 64,
                      seed: int = 0):
    """Synthetic fair-sharing preemption problems for kernel.solve_fair on
    synth_preempt_inputs' cluster (a flat forest at depth 1; at depth 2
    and 3 trees with every 5th CQ attached one level up, a node shared
    at two depths; every 8th CQ outside any cohort): returns (topo dict,
    usage, cohort_usage, fair_args)."""
    topo, usage, cusage = synth_preempt_cluster(
        depth, num_cqs, num_leaf_cohorts, fanout, num_flavors,
        num_resources, seed)
    from kueue_tpu_torch.solver.fairpreempt import fair_args
    batch = synth_fair_problems(topo, num_problems, max_candidates,
                                max_local_cqs, table_rows, seed + 300)
    return topo, usage, cusage, fair_args(batch)


def synth_fair_problems(topo: dict, num_problems: int, max_candidates: int,
                        max_local_cqs: int = 4, table_rows: int = 64,
                        seed: int = 0):
    """Synthetic fair-sharing preemption problems over an encoded topology
    (a dict or a Topology), as a solver/fairpreempt.FairBatch (with no
    problem objects) bucketed as encode_fair_problems buckets them, so
    rows past num_problems are padding problems. Each problem's slots are
    every resource of two flavors (so a share sums two slots per
    resource); the preemptor asks for one flavor's; its candidates sit in
    its own CQ and in CQs of its root cohort (a problem of a CQ outside
    any cohort keeps them in its own); ranks, counts and first positions
    as the encode derives them. The share constants mix borrowing outside
    the slots (base_other, floor_ratio, floor_any), weights 0, 500, 1000
    and 3000, and roots lending nothing in a resource; a third of the
    problems have a borrowWithinCohort threshold."""
    from kueue_tpu_torch.solver.encode import _bucket
    from kueue_tpu_torch.solver.fairpreempt import FairBatch
    from kueue_tpu_torch.solver.preempt import localize_cohorts
    get = topo.get if isinstance(topo, dict) else \
        (lambda name: getattr(topo, name))
    nominal, cq_cohort = get("nominal"), get("cq_cohort")
    Q, F, R = nominal.shape
    rng = np.random.default_rng(seed)
    root_of = np.where(cq_cohort >= 0,
                       get("cohort_root")[np.maximum(cq_cohort, 0)],
                       -1 - np.arange(Q))
    B = _bucket(max(1, num_problems), 1)
    K = _bucket(max(1, max_candidates))
    NS = 2 * R if F > 1 else R
    RF = _bucket(NS)
    QL = _bucket(max_local_cqs, 1)
    b_ = FairBatch()
    b_.gq = np.full((B, QL), -1, np.int32)
    b_.gf = np.full((B, RF), -1, np.int32)
    b_.gr = np.zeros((B, RF), np.int32)
    b_.requests = np.zeros((B, RF), np.int64)
    b_.frs_np = np.zeros((B, RF), bool)
    b_.cand_idx = np.zeros((B, K), np.int32)
    b_.cand_ql = np.full((B, K), -1, np.int16)
    b_.allow_borrowing = np.ones(B, bool)
    b_.threshold_active = np.zeros(B, bool)
    b_.threshold = np.zeros(B, np.int64)
    b_.has_cohort = np.zeros(B, bool)
    b_.cand_rank = np.full((B, K), -1, np.int32)
    b_.cq_count = np.zeros((B, QL), np.int32)
    b_.cq_order = np.full((B, QL), 2**30, np.int32)
    b_.base_other = np.zeros((B, QL, RF), np.int64)
    b_.floor_ratio = np.full((B, QL), -1, np.int64)
    b_.floor_any = np.zeros((B, QL), bool)
    b_.weight = np.full((B, QL), 1000, np.int64)
    b_.lendable = np.zeros((B, RF), np.int64)
    unit = max(1, int(nominal.mean() // 8))
    U = _bucket(table_rows, 1)
    b_.cand_usage = np.zeros((U, RF), np.int64)
    b_.cand_usage[1:, :NS] = rng.integers(0, 5, size=(U - 1, NS)) * unit
    b_.cand_prio = np.zeros(U, np.int32)
    b_.cand_prio[1:] = rng.integers(0, 10, size=U - 1)
    for b in range(num_problems):
        q0 = int(rng.integers(Q))
        has_cohort = cq_cohort[q0] >= 0
        local = [q0]
        if has_cohort:
            peers = np.flatnonzero((root_of == root_of[q0])
                                   & (np.arange(Q) != q0))
            n = min(len(peers), int(rng.integers(1, max_local_cqs)))
            local += [int(x) for x in rng.choice(peers, n, replace=False)]
        b_.gq[b, :len(local)] = local
        flavors = sorted(rng.choice(F, 2, replace=False)) if F > 1 else [0]
        # the slots in FlavorResource order: (flavor, resource) sorted
        slots = [(f, r) for f in flavors for r in range(R)]
        for i, (f, r) in enumerate(slots):
            b_.gf[b, i], b_.gr[b, i] = f, r
        asked = int(rng.integers(len(flavors)))
        for i, (f, r) in enumerate(slots):
            if f == flavors[asked]:
                b_.requests[b, i] = int(rng.integers(1, 12)) * unit \
                    * (rng.uniform() < 0.9)
                b_.frs_np[b, i] = rng.uniform() < 0.8
        if rng.uniform() < 0.1:  # beyond what removing every candidate frees
            b_.requests[b] *= 64
        k = 0 if rng.uniform() < 0.08 else \
            int(rng.integers(1, max_candidates + 1))
        b_.cand_idx[b, :k] = rng.integers(1, U, size=k)
        own_share = rng.uniform(0.1, 0.5)
        b_.cand_ql[b, :k] = np.where(
            (rng.uniform(size=k) < own_share) | (len(local) == 1), 0,
            rng.integers(1, max(2, len(local)), size=k))
        q = b_.cand_ql[b, :k].astype(np.int64)
        for lq in range(len(local)):
            pos = np.flatnonzero(q == lq)
            b_.cand_rank[b, pos] = np.arange(len(pos))
            b_.cq_count[b, lq] = len(pos)
            if len(pos):
                b_.cq_order[b, lq] = pos[0]
        if rng.uniform() < 0.35:
            b_.threshold_active[b] = True
            b_.threshold[b] = int(rng.integers(0, 10))
        b_.has_cohort[b] = has_cohort
        # share constants, the same on every slot of a resource
        lend_r = np.where(rng.uniform(size=R) < 0.15, 0,
                          rng.integers(1, 40, size=R) * 8 * unit)
        for i, (f, r) in enumerate(slots):
            b_.lendable[b, i] = lend_r[r]
        for lq in range(len(local)):
            b_.weight[b, lq] = rng.choice([0, 500, 1000, 1000, 3000]) \
                if rng.uniform() < 0.5 else 1000
            if rng.uniform() < 0.25:
                extra = rng.integers(0, 3, size=R) * unit
                for i, (f, r) in enumerate(slots):
                    b_.base_other[b, lq, i] = extra[r]
            if rng.uniform() < 0.2:
                b_.floor_any[b, lq] = True
                b_.floor_ratio[b, lq] = -1 if rng.uniform() < 0.3 else \
                    int(rng.integers(0, 1500))
    localize_cohorts(b_, get("cq_chain"))
    return b_


def synth_preempt_problems(topo: dict, num_problems: int,
                           max_candidates: int, max_local_cqs: int = 4,
                           table_rows: int = 64, seed: int = 0):
    """Synthetic minimal-preemption problems over an encoded topology (a
    dict or a Topology), as a solver/preempt.PreemptionBatch (with no
    problem objects) bucketed as
    preempt.encode_problems buckets them, so rows past num_problems are
    padding problems. The problems mix within-CQ ones (every candidate
    in the preemptor's CQ), reclaims from other CQs of the preemptor's
    root cohort and borrowWithinCohort threshold ones; each asks for
    every resource of one flavor; some have no candidates or cannot
    fit."""
    from kueue_tpu_torch.solver.encode import _bucket
    from kueue_tpu_torch.solver.preempt import PreemptionBatch, \
        localize_cohorts
    get = topo.get if isinstance(topo, dict) else \
        (lambda name: getattr(topo, name))
    nominal, cq_cohort = get("nominal"), get("cq_cohort")
    Q, F, R = nominal.shape
    rng = np.random.default_rng(seed)
    root_of = np.where(cq_cohort >= 0,
                       get("cohort_root")[np.maximum(cq_cohort, 0)],
                       -1 - np.arange(Q))
    B = _bucket(max(1, num_problems), 1)
    K = _bucket(max(1, max_candidates))
    RF = _bucket(R)
    QL = _bucket(max_local_cqs, 1)
    batch = PreemptionBatch()
    batch.gq = np.full((B, QL), -1, np.int32)
    batch.gf = np.full((B, RF), -1, np.int32)
    batch.gr = np.zeros((B, RF), np.int32)
    batch.requests = np.zeros((B, RF), np.int64)
    batch.frs_np = np.zeros((B, RF), bool)
    batch.cand_idx = np.zeros((B, K), np.int32)
    batch.cand_ql = np.full((B, K), -1, np.int16)
    batch.allow_borrowing = np.zeros(B, bool)
    batch.threshold_active = np.zeros(B, bool)
    batch.threshold = np.zeros(B, np.int64)
    batch.has_cohort = np.zeros(B, bool)
    unit = max(1, int(nominal.mean() // 8))
    U = _bucket(table_rows, 1)
    batch.cand_usage = np.zeros((U, RF), np.int64)
    batch.cand_usage[1:, :R] = rng.integers(1, 7, size=(U - 1, R)) * unit
    batch.cand_prio = np.zeros(U, np.int32)
    batch.cand_prio[1:] = rng.integers(0, 10, size=U - 1)
    for b in range(num_problems):
        q0 = int(rng.integers(Q))
        has_cohort = cq_cohort[q0] >= 0
        kind = rng.choice(("within", "reclaim", "threshold")) \
            if has_cohort else "within"
        local = [q0]
        if kind != "within":
            peers = np.flatnonzero((root_of == root_of[q0])
                                   & (np.arange(Q) != q0))
            n = min(len(peers), int(rng.integers(1, max_local_cqs)))
            local += [int(x) for x in rng.choice(peers, n, replace=False)]
        batch.gq[b, :len(local)] = local
        batch.gf[b, :R] = int(rng.integers(F))
        batch.gr[b, :R] = np.arange(R)
        batch.requests[b, :R] = rng.integers(1, 16, size=R) * unit
        batch.requests[b, :R] *= rng.uniform(size=R) < 0.9
        if rng.uniform() < 0.15:  # beyond what removing every candidate frees
            batch.requests[b, :R] *= 64
        batch.frs_np[b, :R] = rng.uniform(size=R) < 0.7
        batch.frs_np[b, int(rng.integers(R))] = True
        k = 0 if rng.uniform() < 0.1 else \
            int(rng.integers(1, max_candidates + 1))
        batch.cand_idx[b, :k] = rng.integers(1, U, size=k)
        batch.cand_ql[b, :k] = 0 if kind == "within" else \
            rng.integers(0, len(local), size=k)
        batch.allow_borrowing[b] = kind == "threshold" or rng.uniform() < 0.5
        if kind == "threshold":
            batch.threshold_active[b] = True
            batch.threshold[b] = int(rng.integers(0, 10))
        batch.has_cohort[b] = has_cohort
    localize_cohorts(batch, get("cq_chain"))
    return batch


def synth_cluster_inputs(num_clusters: int = 8, num_flavors: int = 32,
                         num_resources: int = 2, num_workloads: int = 2048,
                         num_podsets: int = 4, num_cqs: int = 64,
                         max_capacity: int = 64, seed: int = 0) -> tuple:
    """MultiKueue columns and an admitted batch for score_cluster_columns:
    a quarter of the clusters lost, 70% of the (flavor, resource) cells
    offered, capacity below max_capacity per cell, a few rows' requests
    (so it runs out mid-scan), a share of the rows not admitted or of a CQ without the
    MultiKueue check, requests left in inactive podsets (which must not
    count), and a random admit order. Flavor names are "f0".."f{F-1}" in
    sorted order (f10 before f2), the order of a topology's index.
    Returns (cols, flavors, resources, args): cols the name-space form
    place_remote_dicts takes, args the kernel's (ccap, coffer, cactive,
    mk_cq, requests, podset_active, wl_cq, order, admitted) numpy arrays."""
    rng = np.random.default_rng(seed)
    K, F, R, W, P, Q = (num_clusters, num_flavors, num_resources,
                        num_workloads, num_podsets, num_cqs)
    flavors = sorted(f"f{i}" for i in range(F))
    resources = sorted(f"r{i}" for i in range(R))
    cactive = rng.random(K) < 0.75
    cactive[0] = True
    coffer = rng.random((K, F, R)) < 0.7
    ccap = np.where(coffer, rng.integers(0, max_capacity, size=(K, F, R)),
                    0).astype(np.int64)
    requests = rng.integers(0, 12, size=(W, P, R)).astype(np.int64)
    requests[rng.random(W) < 0.05] = 0            # rows that request nothing
    podset_active = rng.random((W, P)) < 0.6
    podset_active[:, 0] = True
    wl_cq = rng.integers(0, Q, size=W).astype(np.int32)
    mk_cq = rng.random(Q) < 0.6
    admitted = rng.random(W) < 0.7
    order = rng.permutation(W).astype(np.int32)
    cols = tuple(
        (f"w{k}", {(flavors[f], resources[r]): int(ccap[k, f, r])
                   for f in range(F) for r in range(R) if coffer[k, f, r]},
         bool(cactive[k])) for k in range(K))
    return cols, flavors, resources, (ccap, coffer, cactive, mk_cq, requests,
                                      podset_active, wl_cq, order, admitted)


def cluster_oracle(cols: tuple, resources: list, requests, podset_active,
                   wl_cq, order, admitted, mk_cq) -> np.ndarray:
    """score_cluster_columns' result by the host oracle: the admitted rows
    of MultiKueue CQs, walked in `order`, each with its total request over
    the active podsets, through encode.place_remote_dicts on `cols`.
    Returns mk_cluster [W] int32 (the column index, -1 for none)."""
    requests, podset_active = np.asarray(requests), np.asarray(podset_active)
    wl_cq, order = np.asarray(wl_cq), np.asarray(order)
    admitted, mk_cq = np.asarray(admitted), np.asarray(mk_cq)
    treq = np.where(podset_active[:, :, None], requests, 0).sum(1)
    seq = [w for w in order.tolist() if mk_cq[wl_cq[w]] and admitted[w]]
    reqs = [{r: int(treq[w, ri]) for ri, r in enumerate(resources)}
            for w in seq]
    index = {c[0]: i for i, c in enumerate(cols)}
    out = np.full(len(wl_cq), -1, np.int32)
    for w, name in zip(seq, place_remote_dicts(cols, reqs)):
        if name is not None:
            out[w] = index[name]
    return out


def known_columns(cols: tuple, flavor_index: dict,
                  resource_index: dict) -> tuple:
    """The columns cut to what encode_cluster_columns sees: only the
    (flavor, resource) cells the local topology knows."""
    return tuple((name, {(f, r): v for (f, r), v in caps.items()
                         if f in flavor_index and r in resource_index},
                  active) for name, caps, active in cols)
