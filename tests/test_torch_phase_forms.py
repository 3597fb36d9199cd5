"""Parity of Phase A and Phase B with the JAX package on the shapes the
card kernels' forms split on.

csrc/phase_b.cu stages a conflict domain's rows in shared memory (a
global scratch past the launch's share) and walks it on one warp with a
warp vote up to PHASE_B_WARP_FR columns, on the block above;
csrc/phase_a.cu keeps a head's rows in registers for F <= 32, R <= 16
and packs (rank, flavor) into one reduction key. The plain versions the
kernels are held to on the card are held here to the JAX programs on
those shapes, from seeded numpy inputs: FR of 8, 32, 64 and above 256,
several heads of one CQ in a domain, chains 1 to 4 cohorts deep with
empty domains between them, a domain whose rows exceed a block's shared
memory, more than 32 flavors, prefer-no-borrow with a borrowing flavor
of lower index at the non-borrowing target rank, ranks at and around
INF_RANK and past the key's range, and start ranks. The domain tables
phase_b reads are held to a plain Python construction from the
topology. Outputs are int64 and bool: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver.synth import (synth_nested_inputs,
                                          synth_solver_inputs,
                                          synth_start_rank)

KEYS_A = ("fit", "borrows", "chosen", "chosen_borrow", "asg_usage")
KEYS_B = ("admitted", "usage", "cohort_usage")


def make(depth: int, seed: int, Q=24, F=5, R=2, W=40, P=3, cohorts=4,
         no_cohort_every=5):
    """depth 0: flat cohorts (chains of one); else nested trees `depth`
    deep, every `no_cohort_every`-th CQ outside any cohort (its own
    domain). Usage a third of nominal up, so that Phase B rejects some."""
    if depth == 0:
        topo, usage, cu, wl = synth_solver_inputs(
            num_cqs=Q, num_cohorts=cohorts, num_flavors=F, num_resources=R,
            num_workloads=W, num_podsets=P, seed=seed)
    else:
        topo, usage, cu, wl = synth_nested_inputs(
            num_cqs=Q, num_leaf_cohorts=cohorts, fanout=2, depth=depth,
            num_flavors=F, num_resources=R, num_workloads=W, num_podsets=P,
            no_cohort_every=no_cohort_every, seed=seed)
    usage = usage + topo["nominal"] // 3
    wl["solvable"][::7] = False
    return topo, usage, cu, wl


def t(a):
    return torch.from_numpy(np.array(a))


def same(port, ref, names):
    for name, a, b in zip(names, port, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape,
                                                            b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


def jax_topo(topo):
    return {k: jnp.asarray(topo[k]) for k in jk.TOPO_FIELDS}


def phase_a_both(topo, usage, cu, wl, start_rank=None):
    """(port's phase_a on the CPU, the JAX _phase_a) on the same inputs."""
    P = wl["requests"].shape[1]
    tj = jax_topo(topo)
    ref = jk._phase_a(
        tj, jnp.asarray(usage), jk._cohort_avail(tj, jnp.asarray(cu)),
        *(jnp.asarray(wl[k]) for k in ("requests", "podset_active", "wl_cq",
                                       "eligible", "solvable")), P,
        None if start_rank is None else jnp.asarray(start_rank))
    tt = tk.topo_to_device(topo, "cpu")
    got = tk.phase_a(tt, tk.avail(tt, t(usage), t(cu)), t(usage),
                     *(t(wl[k]) for k in ("requests", "podset_active",
                                          "wl_cq", "eligible", "solvable")),
                     P, None if start_rank is None else t(start_rank))
    return got, ref


def phase_b_both(topo, usage, cu, wl):
    """(port's phase_b, the JAX solve_phase_b_domains_impl) on the JAX
    Phase A's outputs and the admit order; also the offsets."""
    fit, borrows, _, _, asg = (np.asarray(a) for a in
                               phase_a_both(topo, usage, cu, wl)[1])
    grid = jk.build_order_grid(fit, borrows, wl["priority"], wl["timestamp"],
                               wl["wl_cq"], topo["cq_cohort"],
                               topo["cohort_subtree"].shape[0],
                               cohort_root=topo["cohort_root"])
    ref = jk.solve_phase_b_domains_impl(
        jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu), jnp.asarray(asg),
        jnp.asarray(fit), jnp.asarray(wl["wl_cq"]), jnp.asarray(grid))
    tt = tk.topo_to_device(topo, "cpu")
    order = tk.admit_order(t(fit), t(borrows), t(wl["priority"]),
                           t(wl["timestamp"]))
    offsets, members = tk.domain_csr(tt, t(wl["wl_cq"]), order)
    got = tk.phase_b(tt, t(usage), t(cu), t(asg), t(fit), t(wl["wl_cq"]),
                     offsets, members)
    return got, ref, offsets


# -- Phase B -----------------------------------------------------------------

@pytest.mark.parametrize("F,R", ((4, 2), (16, 2), (32, 2), (20, 16), (40, 8)))
@pytest.mark.parametrize("depth", (0, 2))
def test_phase_b_widths_match_jax(F, R, depth):
    """FR of 8, 32, 64 (one warp, up to 2 columns a lane) and 320 (the
    block vote)."""
    topo, usage, cu, wl = make(depth, 3, F=F, R=R)
    got, ref, _ = phase_b_both(topo, usage, cu, wl)
    assert np.asarray(ref[0]).any() and not np.asarray(ref[0]).all()
    same(got, ref, KEYS_B)
    plan = tk.phase_b_plan(F * R, topo["cq_chain"].shape[1], 1, 1)
    assert plan["vote"] == ("warp" if F * R <= tk.PHASE_B_WARP_FR
                            else "block")


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("depth", (1, 2, 3, 4))
def test_phase_b_chain_depths_match_jax(depth, seed):
    """Chains 1-4 cohorts deep; every 3rd CQ outside any cohort, so empty
    and solo domains sit between the roots."""
    topo, usage, cu, wl = make(depth, seed, Q=40, cohorts=8, W=60,
                               no_cohort_every=3)
    got, ref, offsets = phase_b_both(topo, usage, cu, wl)
    counts = np.diff(offsets.numpy())
    assert (counts == 0).any() and (counts > 1).any()
    assert topo["cq_chain"].shape[1] == depth
    same(got, ref, KEYS_B)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_phase_b_many_heads_of_one_cq_match_jax(seed):
    """Few CQs and many heads: a domain walks several heads of each CQ,
    over more than one chunk of staged members."""
    topo, usage, cu, wl = make(0, seed, Q=6, cohorts=2, W=160)
    got, ref, offsets = phase_b_both(topo, usage, cu, wl)
    assert np.diff(offsets.numpy()).max() > tk.PHASE_B_CHUNK
    assert np.bincount(wl["wl_cq"]).max() > 1
    same(got, ref, KEYS_B)


@pytest.mark.parametrize("seed", (0, 1))
def test_phase_b_domain_past_shared_memory_matches_jax(seed):
    """Roots whose rows (their CQs and cohorts, 24·FR bytes each) exceed
    the shared state a block holds: on the card they take the lazy form
    (the CQs' constants read from the topology, the rows staged as the
    members touch them)."""
    topo, usage, cu, wl = make(3, seed, Q=192, F=32, R=2, W=160, cohorts=4,
                               no_cohort_every=0)
    tables = tk.domain_tables(topo["cq_cohort"], topo["cohort_root"],
                              topo["cq_chain"])
    rows = int(tables["dom_nq"].max() + tables["dom_nc"].max())
    plan = tk.phase_b_plan(64, 3, tables["dom_cqs"].shape[1],
                           tables["dom_cohorts"].shape[1])
    assert rows * 24 * 64 > plan["state_cap"]
    tt = tk.topo_to_device(topo, "cpu")
    assert "lazy" in tk.phase_b_forms(tt, plan, 64)
    got, ref, _ = phase_b_both(topo, usage, cu, wl)
    same(got, ref, KEYS_B)


# -- Phase A -----------------------------------------------------------------

@pytest.mark.parametrize("variant", ("plain", "start_rank", "no_borrow"))
@pytest.mark.parametrize("F,R", ((32, 2), (32, 16), (40, 2), (33, 3),
                                 (8, 17)))
def test_phase_a_forms_match_jax(F, R, variant):
    """The register form's widest shapes (F = 32, R = 2 and 16) and the
    general form's (F > 32: strided lanes; R = 17)."""
    topo, usage, cu, wl = make(2, 5, F=F, R=R)
    if variant == "no_borrow":
        topo["prefer_no_borrow"] = np.ones_like(topo["prefer_no_borrow"])
    sr = synth_start_rank(wl, F, 5) if variant == "start_rank" else None
    got, ref = phase_a_both(topo, usage, cu, wl, sr)
    same(got, ref, KEYS_A)
    assert got[0].any()
    want = "register" if F <= 32 and R <= 16 else "general"
    assert tk.phase_a_plan(F, R, wl["requests"].shape[1])["form"] == want


def no_borrow_target_inputs():
    """Three flavors of ranks 1, 0, 1 in every CQ, prefer-no-borrow on:
    flavors 0 and 1 are full (every request borrows) and alike, flavor 2
    empty. Where 0 and 1 fit, the best rank is 0 (flavor 1) and the best
    non-borrowing rank 1 (flavor 2); the target is rank 1, and the lowest
    fitting index at it is flavor 0, which borrows."""
    topo, usage, cu, wl = synth_solver_inputs(
        num_cqs=8, num_cohorts=2, num_flavors=3, num_resources=1,
        num_workloads=24, num_podsets=2, seed=11)
    Q = topo["cq_cohort"].shape[0]
    topo["flavor_rank"] = np.tile(np.array([1, 0, 1], np.int32), (Q, 1))
    topo["prefer_no_borrow"] = np.ones(Q, bool)
    topo["nominal"][:, 1] = topo["nominal"][:, 0]
    usage = np.zeros_like(usage)
    usage[:, :2] = topo["nominal"][:, :2]
    for c in range(topo["cohort_subtree"].shape[0]):
        members = topo["cq_cohort"] == c
        topo["cohort_subtree"][c] = topo["nominal"][members].sum(axis=0)
        cu[c] = usage[members].sum(axis=0)
    topo["cohort_subtree"][:, :2] *= 2  # room to borrow in flavors 0 and 1
    wl["requests"] = np.minimum(wl["requests"], 3000)
    return topo, usage, cu, wl


def test_phase_a_no_borrow_target_takes_lowest_fitting_index():
    topo, usage, cu, wl = no_borrow_target_inputs()
    got, ref = phase_a_both(topo, usage, cu, wl)
    same(got, ref, KEYS_A)
    chosen, chosen_borrow = np.asarray(ref[2]), np.asarray(ref[3])
    # the reference takes flavor 0 (borrowing) at the non-borrowing rank
    assert ((chosen == 0) & chosen_borrow).any()


@pytest.mark.parametrize("F", (5, 40))
@pytest.mark.parametrize("mode", ("near_inf", "past_key"))
@pytest.mark.parametrize("seed", (0, 1))
def test_phase_a_extreme_ranks_match_jax(mode, seed, F):
    """Ranks of INF_RANK - 1, INF_RANK and INF_RANK + 1 (a candidate of
    rank INF_RANK or more chooses nothing), and ranks past the packed
    key's range (-2^27, 2^27, 2^30: the card takes two reductions)."""
    topo, usage, cu, wl = make(2, seed, F=F)
    rng = np.random.default_rng(seed)
    fr = topo["flavor_rank"]
    pick = rng.random(fr.shape) < 0.3
    values = ([tk.INF_RANK - 1, tk.INF_RANK, tk.INF_RANK + 1]
              if mode == "near_inf" else [-(2**27), 2**27, 2**30, -3])
    topo["flavor_rank"] = np.where(pick, rng.choice(values, size=fr.shape),
                                   fr).astype(np.int32)
    topo["prefer_no_borrow"] = rng.random(fr.shape[0]) < 0.5
    sr = synth_start_rank(wl, F, seed)
    for start_rank in (None, sr):
        got, ref = phase_a_both(topo, usage, cu, wl, start_rank)
        same(got, ref, KEYS_A)


# -- the domain tables ---------------------------------------------------------

def tables_by_hand(cq_cohort, cohort_root, cq_chain):
    """domain_tables' content, one CQ and cohort at a time."""
    C, Q = len(cohort_root), len(cq_cohort)
    roots = [c for c in range(C) if cohort_root[c] == c]
    cqs = {r: [q for q in range(Q) if cq_cohort[q] >= 0
               and cohort_root[cq_cohort[q]] == r] for r in roots}
    cohorts = {r: [c for c in range(C) if cohort_root[c] == r]
               for r in roots}
    cq_slot = [0] * Q
    for r in roots:
        for i, q in enumerate(cqs[r]):
            cq_slot[q] = i
    chain_slot = [[cohorts[cohort_root[c]].index(c) if c >= 0 else -1
                   for c in row] for row in cq_chain]
    return roots, [q for q in range(Q) if cq_cohort[q] < 0], cqs, cohorts, \
        cq_slot, chain_slot


@pytest.mark.parametrize("depth", (0, 1, 3, 4))
def test_domain_tables_match_hand_construction(depth):
    topo = make(depth, 2, Q=30, cohorts=6)[0]
    args = (topo["cq_cohort"], topo["cohort_root"], topo["cq_chain"])
    tab = tk.domain_tables(*args)
    roots, solo, cqs, cohorts, cq_slot, chain_slot = tables_by_hand(
        *(a.tolist() for a in args))
    assert tab["dom_roots"].tolist() == roots
    assert tab["dom_solo"].tolist() == solo
    for b, r in enumerate(roots):
        assert tab["dom_row"][r] == b
        row_q = tab["dom_cqs"][b].tolist()
        row_c = tab["dom_cohorts"][b].tolist()
        assert row_q[:len(cqs[r])] == cqs[r]
        assert set(row_q[len(cqs[r]):]) <= {-1}
        assert row_c[:len(cohorts[r])] == cohorts[r]
        assert set(row_c[len(cohorts[r]):]) <= {-1}
        assert tab["dom_nq"][b] == len(cqs[r])
        assert tab["dom_nc"][b] == len(cohorts[r])
    assert (tab["dom_row"][[c for c in range(len(topo["cohort_root"]))
                            if c not in roots]] == -1).all()
    assert tab["cq_slot"].tolist() == cq_slot
    assert tab["cq_chain_slot"].tolist() == chain_slot
    for name, a in tab.items():
        assert a.dtype == np.int32, name
    on_device = tk.topo_to_device(topo, "cpu")
    assert set(tk.DOMAIN_FIELDS) <= set(on_device)
    assert torch.equal(on_device["dom_cqs"], torch.from_numpy(tab["dom_cqs"]))


def test_domain_tables_refuse_a_chain_outside_its_tree():
    topo = make(2, 0)[0]
    chain = topo["cq_chain"].copy()
    q = int(np.flatnonzero(chain[:, 1] >= 0)[0])
    other = [c for c in range(len(topo["cohort_root"]))
             if topo["cohort_root"][c] != topo["cohort_root"][chain[q, 0]]]
    chain[q, 1] = other[0]
    with pytest.raises(ValueError):
        tk.domain_tables(topo["cq_cohort"], topo["cohort_root"], chain)


def test_phase_b_plan_budgets():
    """The block's shared memory within PHASE_B_SMEM; the rows' share at
    most the largest domain's shared form (after the warp form's header);
    assignment rows staged up to FR = 2048, read from global past it; the
    vote by width; the scratch when a domain may not fit even the hybrid
    form; and the forms the north star's and a nested topology's domains
    take."""
    north = tk.phase_b_plan(64, 1, 8, 1)  # the north star: 9 rows
    assert north["state_cap"] >= 9 * 24 * 64 and not north["scratch"]
    assert north["vote"] == "warp" and north["stage_asg"]
    for FR, DC, SQ, SC in ((64, 3, 128, 21), (320, 2, 12, 7),
                           (2048, 1, 8, 1), (2560, 4, 40, 9)):
        plan = tk.phase_b_plan(FR, DC, SQ, SC)
        rows = SQ + SC
        head = tk._lazy_head(rows, FR) if FR <= 256 else 0
        assert plan["smem"] <= tk.PHASE_B_SMEM
        assert plan["state_cap"] <= head + 24 * FR * rows
        assert plan["scratch"] == (head + 8 * FR * (SQ + 3 * SC)
                                   > plan["state_cap"])
        assert plan["stage_asg"] == (FR <= 2048)
        assert plan["vote"] == ("warp" if FR <= 256 else "block")
        assert plan["chunk"] >= 1
    for depth, want in ((0, {"shared"}), (3, {"lazy"})):
        topo = make(depth, 0, Q=192 if depth else 24, F=32, R=2,
                    no_cohort_every=0 if depth else 5)[0]
        tt = tk.topo_to_device(topo, "cpu")
        plan = tk.phase_b_plan(64, tt["cq_chain"].shape[1],
                               tt["dom_cqs"].shape[1],
                               tt["dom_cohorts"].shape[1])
        assert set(tk.phase_b_forms(tt, plan, 64)) == want
