"""Synthetic solver inputs for the kernel phases of chip_smoke.py and the
parity tests.

Builds solver input arrays (numpy) for a parameterized cluster shape without
going through the Python object model (the object path is exercised by
tests; this measures the device program at scale).
"""

from __future__ import annotations

import numpy as np


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
                        no_cohort_every: int = 0, seed: int = 0):
    """Like synth_solver_inputs, with cohort trees `depth` levels deep
    (leaf cohorts first, `fanout` children per parent), lending and
    borrowing limits on some CQs and cohorts, TryNextFlavor on some CQs,
    and every `no_cohort_every`-th CQ outside any cohort (0 = none).
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


def synth_start_rank(wl: dict, num_flavors: int, seed: int = 0) -> np.ndarray:
    """A flavor-resume position for about a third of the (workload,
    podset, resource) slots: start_rank [W,P,R] int32."""
    rng = np.random.default_rng(seed + 2)
    shape = wl["requests"].shape
    return np.where(rng.uniform(size=shape) < 0.3,
                    rng.integers(0, num_flavors, size=shape), 0).astype(np.int32)
