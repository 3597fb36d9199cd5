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
                 seed: int = 0, level_pairs: int = 0) -> tuple:
    """A delta prologue for kernel.apply_state_deltas: `num_coords`
    unique (q, f, r) coords with net deltas that keep usage non-negative
    (finishes free at most what is used, admissions add up to nominal),
    encoded as encode.encode_deltas encodes the journal's corrections.
    With `level_pairs`, that many of the coords come in pairs that put
    one cohort coord at two levels of the tuple: a CQ attached to a
    cohort P and a CQ of a child cohort of P, at the same (f, r), so (P,
    f, r) is at level 0 and level 1 (the topology must attach CQs at two
    depths, as synth_nested_inputs' attach_up_every does)."""
    rng = np.random.default_rng(seed + 3)
    Q, F, R = usage.shape
    cells = []
    if level_pairs:
        cq_cohort, parent = topo["cq_cohort"], topo["cohort_parent"]
        ups = [q for q in range(Q) if cq_cohort[q] >= 0
               and (parent[np.maximum(cq_cohort, 0)][cq_cohort >= 0]
                    == cq_cohort[q]).any()]
        if not ups:
            raise ValueError("no CQ is attached to a cohort with child "
                             "cohorts")
        for i in rng.choice(len(ups), size=level_pairs):
            up = ups[i]
            below = np.flatnonzero((cq_cohort >= 0) & (
                parent[np.maximum(cq_cohort, 0)] == cq_cohort[up]))
            f, r = rng.integers(0, F), rng.integers(0, R)
            cells += [(up * F + f) * R + r,
                      (int(rng.choice(below)) * F + f) * R + r]
        cells = list(dict.fromkeys(cells))
    rest = np.setdiff1d(np.arange(Q * F * R), cells)
    cells += list(rng.choice(rest, size=min(num_coords - len(cells),
                                            rest.size), replace=False))
    coords = []
    for q, f, r in zip(*np.unravel_index(np.asarray(cells, np.int64),
                                         (Q, F, R))):
        lo, hi = -int(usage[q, f, r]), int(topo["nominal"][q, f, r])
        coords.append((int(q), int(f), int(r),
                       int(rng.integers(lo, hi + 1)) or 1000))
    return deltas_from_coords(coords, topo["cq_chain"], topo["cohort_parent"])


def shared_level_coords(lvl_c: np.ndarray) -> int:
    """How many cohort coords of a delta tuple's lvl_c [L,D,3] sit at two
    or more of its levels."""
    seen = {}
    for lvl in range(lvl_c.shape[0]):
        for c, f, r in lvl_c[lvl][lvl_c[lvl, :, 0] >= 0].tolist():
            seen.setdefault((c, f, r), set()).add(lvl)
    return sum(len(v) > 1 for v in seen.values())


def synth_share_inputs(num_flavors: int, num_resources: int,
                       num_cqs: int = 64, num_workloads: int = 96,
                       scale: int = 1, seed: int = 0) -> tuple:
    """drf_share's inputs at any F and R: synth_nested_inputs' two-level
    trees (every 9th CQ outside any cohort), some flavors not offered,
    usage between 0 and 1.5x nominal, fair weights 0/500/1000/3000, the
    first root lending nothing (its borrowers' drs is -1, so weight 3000
    gives -1000 // 3000 = -1) and the second lending nothing in every
    other resource, and half the heads' [F,R] assignment cells up to
    nominal. Quantities are multiplied by `scale` (a power of two keeps
    the ratios) to reach the int64 extremes. Returns (topo, usage,
    asg_usage, wl_cq)."""
    topo, _, _, wl = synth_nested_inputs(
        num_cqs=num_cqs, num_leaf_cohorts=8, fanout=2, depth=2,
        num_flavors=num_flavors, num_resources=num_resources,
        num_workloads=num_workloads, num_podsets=1, no_cohort_every=9,
        seed=seed)
    rng = np.random.default_rng(seed + 5)
    nominal = topo["nominal"]
    Q, F, R = nominal.shape
    topo["fair_weight"] = np.array([0, 500, 1000, 3000], np.int64)[
        rng.integers(0, 4, size=Q)]
    topo["offered"] = rng.uniform(size=(Q, F, R)) < 0.8
    lend = topo["cohort_lendable"].copy()
    roots = np.unique(topo["cohort_root"][topo["cq_cohort"][
        topo["cq_cohort"] >= 0]])
    lend[roots[0]] = 0
    if roots.size > 1:
        lend[roots[1], ::2] = 0
    topo["cohort_lendable"] = lend * scale
    topo["nominal"] = nominal * scale
    usage = (nominal * rng.uniform(0, 1.5, size=(Q, F, R))).astype(
        np.int64) * scale
    wl_cq = wl["wl_cq"]
    W = wl_cq.shape[0]
    asg = np.where(rng.uniform(size=(W, F, R)) < 0.5,
                   (nominal[wl_cq] * rng.uniform(size=(W, F, R))).astype(
                       np.int64), 0) * scale
    return topo, usage, asg, wl_cq


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


def synth_full_k_inputs(num_problems: int, K: int, seed: int) -> tuple:
    """synth_preempt_inputs at K candidates a problem (K one of the
    encode's buckets), whose problem 0 has exactly K: all in its CQ,
    which is in no cohort, asking on every resource for what only the
    removal of every candidate frees. So k* is K - 1, and the run of CQ 0
    in the candidates' CQ order ends at position K. The other problems
    have up to K candidates."""
    topo, usage, cu, args = synth_preempt_inputs(num_problems, K, depth=2,
                                                 seed=seed)
    args = [np.array(a, copy=True) for a in args]
    gq, gf, gr, gc, chain, req, frs, cidx, cql, tab_u = args[:10]
    if cql.shape[1] != K:
        raise ValueError(f"K {K} is not a candidate bucket "
                         f"({cql.shape[1]})")
    q0 = int(np.flatnonzero(topo["cq_cohort"] < 0)[0])
    R = usage.shape[2]
    gq[0] = -1
    gq[0, 0] = q0
    gc[0] = -1
    chain[0] = -1
    gf[0] = -1
    gf[0, :R] = 0
    gr[0] = 0
    gr[0, :R] = np.arange(R)
    cidx[0] = np.random.default_rng(seed).integers(1, tab_u.shape[0], K)
    cql[0] = 0
    req[0] = 0
    req[0, :R] = tab_u[1:, :R].min(0)
    frs[0] = False
    frs[0, :R] = True
    args[11][0] = args[12][0] = args[14][0] = False  # borrowing, threshold
    usage = usage.copy()
    usage[q0, 0] = (topo["nominal"][q0, 0] + tab_u[cidx[0], :R].sum(0)
                    - req[0, :R])
    return topo, usage, cu, args


def fill_inactive_slots(args: tuple, num_flavors: int, num_resources: int,
                        seed: int = 0, every_slot: bool = False) -> tuple:
    """A copy of preempt_args (synth_preempt_inputs') in which each real
    problem's inactive slots (no request, not needs-preemption) point at
    a real (flavor, resource) and every candidate-table row has usage in
    the slots past num_resources. No output may change: the kernel's
    slot compaction rests on it. With every_slot, each slot of a real
    problem that was inactive or padding asks for the smallest request
    of the batch instead, so every slot is active."""
    args = [np.array(a, copy=True) for a in args]
    gq, gf, gr, req, frs, tab_u = (args[0], args[1], args[2], args[5],
                                   args[6], args[9])
    rng = np.random.default_rng(seed)
    real = (gq[:, 0] >= 0)[:, None]
    if every_slot:
        off = real & ((gf < 0) | ((req <= 0) & ~frs))
    else:
        off = real & (req <= 0) & ~frs
    n = int(off.sum())
    gf[off] = rng.integers(0, num_flavors, size=n)
    gr[off] = rng.integers(0, num_resources, size=n)
    unit = int(req[req > 0].min())
    tab_u[1:, num_resources:] = rng.integers(
        1, 7, size=tab_u[1:, num_resources:].shape) * unit
    if every_slot:
        req[off] = unit
    return tuple(args)


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


# the fair batch's argument positions (fairpreempt.fair_args)
_FAIR_BASE, _FAIR_FLOOR, _FAIR_FANY, _FAIR_WEIGHT, _FAIR_LEND = 17, 18, 19, \
    20, 21


def synth_fair_edges(kind: str, num_problems: int = 48,
                     max_candidates: int = 24, seed: int = 0, **kw):
    """synth_fair_inputs' batch bent to an edge of K11's arithmetic:
    "ties": every CQ at its nominal usage and every cohort at its subtree
    (so nothing is borrowed and a removal frees without borrowing),
    lendable 1000 and weight 1000 (or 0, 2^62, for a third of the CQs),
    and base_other setting each CQ's share to one of a few values that
    share a high word and differ in the low one, several equal (the tie
    goes to cq_order, then the slot); "limits": borrow limits of CQs and
    cohorts at and around 2^61 / 4, the clamp, and weight 0 for a third
    of the CQs. Returns (topo, usage, cohort_usage, fair_args)."""
    topo, usage, cu, args = synth_fair_inputs(num_problems, max_candidates,
                                              seed=seed, **kw)
    rng = np.random.default_rng(seed + 500)
    args = [a.copy() for a in args]
    B, QL, RF = args[_FAIR_BASE].shape
    weight = args[_FAIR_WEIGHT]
    weight[:] = np.where(rng.uniform(size=(B, QL)) < 0.3, 0, 1000)
    if kind == "ties":
        usage = topo["nominal"].copy()
        cu = topo["cohort_subtree"].copy()
        high = rng.integers(1, 4, size=(B, 1)) << 32
        low = np.array([5, 7, 5, 7, 9], np.int64)[
            rng.integers(0, 5, size=(B, QL))]
        args[_FAIR_BASE][:] = 0
        args[_FAIR_BASE][:, :, 0] = high + low
        args[_FAIR_LEND][:] = 1000
        args[_FAIR_FLOOR][:] = -1
        args[_FAIR_FANY][:] = False
    elif kind == "limits":
        lim = (2**61) // 4
        edges = np.array([lim - 1, lim, lim + 1, 2**61, 0], np.int64)
        for name in ("borrow_limit", "cohort_borrow_limit"):
            t = topo[name] = topo[name].copy()
            pick = rng.uniform(size=t.shape) < 0.5
            t[pick] = edges[rng.integers(0, len(edges), size=int(pick.sum()))]
    else:
        raise ValueError(f"unknown edge kind {kind!r}")
    return topo, usage, cu, tuple(args)


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
                         max_capacity: int = 64, seed: int = 0,
                         requested_share: float = 1.0,
                         negative_share: float = 0.0) -> tuple:
    """MultiKueue columns and an admitted batch for score_cluster_columns:
    a quarter of the clusters lost, 70% of the (flavor, resource) cells
    offered, capacity below max_capacity per cell, a few rows' requests
    (so it runs out mid-scan), a share of the rows not admitted or of a CQ without the
    MultiKueue check, requests left in inactive podsets (which must not
    count), and a random admit order. Below 1, requested_share is the
    chance that a row asks for a resource at all (wide resource axes then
    still find columns offering every resource a row asks for); above 0,
    negative_share is the share of rows whose first podset asks for a
    negative amount of one resource (which no column has to cover, and
    whose debit gives the column capacity back). Flavor names are
    "f0".."f{F-1}" in sorted order (f10 before f2), the order of a
    topology's index. Returns (cols, flavors, resources, args): cols the
    name-space form place_remote_dicts takes, args the kernel's (ccap,
    coffer, cactive, mk_cq, requests, podset_active, wl_cq, order,
    admitted) numpy arrays."""
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
    if requested_share < 1.0:
        requests *= rng.random((W, 1, R)) < requested_share
    if negative_share > 0.0:
        neg = np.flatnonzero(rng.random(W) < negative_share)
        requests[neg, 0, rng.integers(0, R, size=neg.size)] = \
            -rng.integers(1, 12, size=neg.size)
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
