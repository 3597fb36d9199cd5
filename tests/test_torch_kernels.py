"""Parity of the port's kernel module with the JAX package.

Each plain PyTorch version in kueue_tpu_torch.solver.kernel (the code a
wrapper runs for CPU tensors) against its JAX counterpart in
kueue_tpu.solver.kernel, on the same seeded numpy inputs: flat cohorts
from the JAX package's synth, hand-built nested trees of depth 2 and 3
with CQs outside any cohort, up to 3 podsets. The admit order is held
against the order grid the JAX fused program builds (with ties and
padding rows, and with the fair-sharing shares of drf_share, which is
held against _drf_share with fair weights 0/500/1000/3000 and roots that
lend nothing), the state deltas against apply_state_deltas_impl and the
numpy mirror, the arena scatter and gather against theirs. Outputs are
int64 and bool, so every comparison is exact equality.

tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on the card.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu.core.resources import FlavorResource as JaxFR
from kueue_tpu.solver import encode as jenc
from kueue_tpu.solver.synth import synth_solver_inputs
from kueue_tpu_torch.core.resources import FlavorResource as TorchFR
from kueue_tpu_torch.solver import encode as tenc
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver.synth import synth_nested_inputs, synth_start_rank

Q, F, R, W, P = 24, 5, 2, 40, 3
KINDS = ("flat", "nested2", "nested3")
SEEDS = (0, 1, 2)
WL_KEYS = ("requests", "podset_active", "wl_cq", "priority", "timestamp",
           "eligible", "solvable")


def make_inputs(kind: str, seed: int, num_resources: int = R):
    if kind == "flat":
        topo, usage, cu, wl = synth_solver_inputs(
            num_cqs=Q, num_cohorts=4, num_flavors=F,
            num_resources=num_resources, num_workloads=W, num_podsets=P,
            seed=seed)
    else:
        topo, usage, cu, wl = synth_nested_inputs(
            num_cqs=Q, num_leaf_cohorts=4, fanout=2, depth=int(kind[-1]),
            num_flavors=F, num_resources=num_resources, num_workloads=W,
            num_podsets=P, no_cohort_every=5, seed=seed)
    # a tighter cluster, so that phase B rejects some heads
    usage = usage + topo["nominal"] // 3
    wl["solvable"][::7] = False
    return topo, usage, cu, wl


def jax_topo(topo):
    return {k: jnp.asarray(topo[k]) for k in jk.TOPO_FIELDS}


def torch_topo(topo):
    return tk.topo_to_device(topo, "cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def assert_same(port, ref, name=""):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    assert port.dtype == ref.dtype, (name, port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref, err_msg=name)


def jax_phase_a(topo, usage, cu, wl, start_rank=None):
    tj = jax_topo(topo)
    cavail = jk._cohort_avail(tj, jnp.asarray(cu))
    return jk._phase_a(
        tj, jnp.asarray(usage), cavail, jnp.asarray(wl["requests"]),
        jnp.asarray(wl["podset_active"]), jnp.asarray(wl["wl_cq"]),
        jnp.asarray(wl["eligible"]), jnp.asarray(wl["solvable"]), P,
        None if start_rank is None else jnp.asarray(start_rank))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_avail_matches_jax(kind, seed):
    topo, usage, cu, _ = make_inputs(kind, seed)
    tj = jax_topo(topo)
    ref = jk._available(tj["nominal"], tj["borrow_limit"], tj["guaranteed"],
                        jnp.asarray(usage),
                        jk._cohort_avail(tj, jnp.asarray(cu)),
                        tj["cq_cohort"])
    assert_same(tk.avail(torch_topo(topo), t(usage), t(cu)), ref, "avail")


@pytest.mark.parametrize("variant", ("plain", "start_rank", "no_borrow"))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_phase_a_matches_jax(kind, seed, variant):
    topo, usage, cu, wl = make_inputs(kind, seed)
    start_rank = synth_start_rank(wl, F, seed) if variant == "start_rank" \
        else None
    if variant == "no_borrow":
        topo["prefer_no_borrow"] = np.ones(Q, bool)
    ref = jax_phase_a(topo, usage, cu, wl, start_rank)
    tt = torch_topo(topo)
    avail_q = tk.avail(tt, t(usage), t(cu))
    got = tk.phase_a(tt, avail_q, t(usage), *(t(wl[k]) for k in
                                               ("requests", "podset_active",
                                                "wl_cq", "eligible",
                                                "solvable")),
                     P, None if start_rank is None else t(start_rank))
    for name, a, b in zip(("fit", "borrows", "chosen", "chosen_borrow",
                           "asg_usage"), got, ref):
        assert_same(a, b, name)


@pytest.mark.parametrize("variant", ("plain", "start_rank"))
@pytest.mark.parametrize("num_resources", (17, 32))
@pytest.mark.parametrize("kind", KINDS)
def test_phase_a_wide_resources_match_jax(kind, num_resources, variant):
    """Phase A over more than 16 resources: 17 names as they are and 32,
    the encode's bucket for 17 to 32 (the kernel keeps the chosen flavor
    of each resource in shared memory, so the plain version it is held
    to on the card must take any R)."""
    topo, usage, cu, wl = make_inputs(kind, 4, num_resources)
    start_rank = synth_start_rank(wl, F, 4) if variant == "start_rank" \
        else None
    ref = jax_phase_a(topo, usage, cu, wl, start_rank)
    tt = torch_topo(topo)
    got = tk.phase_a(tt, tk.avail(tt, t(usage), t(cu)), t(usage),
                     *(t(wl[k]) for k in ("requests", "podset_active",
                                          "wl_cq", "eligible", "solvable")),
                     P, None if start_rank is None else t(start_rank))
    for name, a, b in zip(("fit", "borrows", "chosen", "chosen_borrow",
                           "asg_usage"), got, ref):
        assert_same(a, b, name)
    assert got[2].shape[2] == num_resources and got[0].any()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_phase_b_matches_jax(kind, seed):
    topo, usage, cu, wl = make_inputs(kind, seed)
    fit, borrows, _, _, asg = (np.asarray(a) for a in
                               jax_phase_a(topo, usage, cu, wl))
    grid = jk.build_order_grid(fit, borrows, wl["priority"], wl["timestamp"],
                               wl["wl_cq"], topo["cq_cohort"],
                               topo["cohort_subtree"].shape[0],
                               cohort_root=topo["cohort_root"])
    ref = jk.solve_phase_b_domains_impl(
        jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu),
        jnp.asarray(asg), jnp.asarray(fit), jnp.asarray(wl["wl_cq"]),
        jnp.asarray(grid))
    tt = torch_topo(topo)
    order = tk.admit_order(t(fit), t(borrows), t(wl["priority"]),
                           t(wl["timestamp"]))
    offsets, members = tk.domain_csr(tt, t(wl["wl_cq"]), order)
    got = tk.phase_b(tt, t(usage), t(cu), t(asg), t(fit), t(wl["wl_cq"]),
                     offsets, members)
    assert np.asarray(ref[0]).any() and not np.asarray(ref[0]).all()
    for name, a, b in zip(("admitted", "usage", "cohort_usage"), got, ref):
        assert_same(a, b, name)


@pytest.mark.parametrize("seed", SEEDS)
def test_admit_order_matches_lexsort(seed):
    rng = np.random.default_rng(seed)
    fit = rng.uniform(size=W) < 0.7
    borrows = rng.uniform(size=W) < 0.4
    priority = rng.integers(0, 3, size=W).astype(np.int64)
    timestamp = rng.integers(0, 5, size=W).astype(np.float64)  # ties
    ref = np.lexsort((timestamp, -priority, np.zeros(W, np.int64),
                      borrows.astype(np.int32), (~fit).astype(np.int32)))
    got = tk.admit_order(t(fit), t(borrows), t(priority), t(timestamp))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("num_workloads", (1, 13, 64))
@pytest.mark.parametrize("seed", SEEDS)
def test_pack_matches_jax(seed, num_workloads):
    rng = np.random.default_rng(seed)
    n = num_workloads
    dense = {
        "chosen": rng.integers(-1, F, size=(n, P, R)).astype(np.int32),
        "chosen_borrow": rng.uniform(size=(n, P, R)) < 0.3,
        "fit": rng.uniform(size=n) < 0.6,
        "admitted": rng.uniform(size=n) < 0.4,
        "borrows": rng.uniform(size=n) < 0.2,
    }
    ref = jk.pack_decisions_impl({k: jnp.asarray(v) for k, v in dense.items()})
    got = tk.pack(*(t(dense[k]) for k in ("chosen", "chosen_borrow", "fit",
                                          "admitted", "borrows")))
    assert_same(got[0], ref["dec_pr"], "dec_pr")
    assert_same(got[1], ref["dec_bits"], "dec_bits")


@pytest.mark.parametrize("fair", (False, True))
@pytest.mark.parametrize("compact", (True, False))
@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("kind", KINDS)
def test_solve_cycle_fused_matches_jax(kind, seed, compact, fair):
    topo, usage, cu, wl = make_inputs(kind, seed)
    if fair:
        topo, wl = with_fair_sharing(topo, wl, seed)
    start_rank = synth_start_rank(wl, F, seed) if compact else None
    max_rank = jk.max_rank_bound(wl["wl_cq"], topo["cq_cohort"],
                                 topo["cohort_root"])
    assert tk.max_rank_bound(wl["wl_cq"], topo["cq_cohort"],
                             topo["cohort_root"]) == max_rank
    ref = jk.solve_cycle_fused(
        jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu),
        *(jnp.asarray(wl[k]) for k in WL_KEYS), num_podsets=P,
        max_rank=max_rank, fair_sharing=fair,
        start_rank=None if start_rank is None else jnp.asarray(start_rank),
        compact=compact)
    got = tk.solve_cycle_fused(
        torch_topo(topo), t(usage), t(cu), *(t(wl[k]) for k in WL_KEYS),
        num_podsets=P, max_rank=max_rank, fair_sharing=fair,
        start_rank=None if start_rank is None else t(start_rank),
        compact=compact)
    assert set(got) == set(ref)
    for k in ref:
        assert_same(got[k], ref[k], k)


def fused_order_grid(topo, usage, cu, wl, monkeypatch, fair_sharing=False):
    """The JAX package's K4 as its fused program computes it: run
    solve_cycle_fused_impl eagerly and capture the [L,D] order grid it
    hands to phase B. Returns (grid, fit, borrows)."""
    captured = {}
    real = jk.solve_phase_b_domains_impl

    def capture(topo_, usage_, cohort_, asg, fit, wl_cq, grid):
        captured["grid"] = np.asarray(grid)
        return real(topo_, usage_, cohort_, asg, fit, wl_cq, grid)

    monkeypatch.setattr(jk, "solve_phase_b_domains_impl", capture)
    out = jk.solve_cycle_fused_impl(
        jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu),
        *(jnp.asarray(wl[k]) for k in WL_KEYS), num_podsets=P,
        max_rank=wl["wl_cq"].shape[0], fair_sharing=fair_sharing)
    return captured["grid"], np.asarray(out["fit"]), np.asarray(out["borrows"])


def with_ties_and_padding(wl, seed):
    """Few distinct priorities and timestamps (ties broken by index), and
    the last rows padding as the encoder pads: wl_cq 0, nothing active,
    not solvable."""
    rng = np.random.default_rng(seed)
    W = wl["wl_cq"].shape[0]
    wl["priority"] = rng.integers(-1, 2, size=W).astype(np.int64)
    wl["timestamp"] = rng.integers(0, 3, size=W).astype(np.float64)
    pad = slice(W - 6, W)
    for k in ("requests", "podset_active", "eligible", "solvable",
              "priority", "timestamp"):
        wl[k][pad] = 0
    wl["wl_cq"][pad] = 0
    return wl


WEIGHTS = np.array([0, 500, 1000, 3000], np.int64)


def root_cohorts(topo):
    cohorts = topo["cq_cohort"][topo["cq_cohort"] >= 0]
    return np.unique(topo["cohort_root"][cohorts])


def with_fair_sharing(topo, wl, seed):
    """Fair weights from {0, 500, 1000, 3000}; the last root cohort lends
    in one resource only and, where there are several roots, the first
    lends nothing (its borrowers' ratio is -1, so their share is
    -1000 // weight, floored); ties and padding rows as
    with_ties_and_padding."""
    rng = np.random.default_rng(seed + 100)
    topo["fair_weight"] = WEIGHTS[rng.integers(0, 4, size=Q)]
    lend = topo["cohort_lendable"].copy()
    roots = root_cohorts(topo)
    lend[roots[-1], 0] = 0
    if len(roots) > 1:
        lend[roots[0]] = 0
    topo["cohort_lendable"] = lend
    return topo, with_ties_and_padding(wl, seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_drf_share_matches_jax(kind, seed):
    topo, usage, cu, wl = make_inputs(kind, seed)
    topo, wl = with_fair_sharing(topo, wl, seed)
    asg = np.asarray(jax_phase_a(topo, usage, cu, wl)[4])
    ref = np.asarray(jk._drf_share(jax_topo(topo), jnp.asarray(usage),
                                   jnp.asarray(asg), jnp.asarray(wl["wl_cq"])))
    got = tk.drf_share(torch_topo(topo), t(usage), t(asg), t(wl["wl_cq"]))
    assert_same(got, ref, "share")
    # the inputs reach every branch: no borrowing, a ratio, weight 0 and,
    # with several roots, the -1 of a root lending nothing
    assert (ref == 0).any() and (ref > 0).any()
    assert (ref == tk.NO_LIMIT).any()
    assert (ref < 0).any() == (len(root_cohorts(topo)) > 1)


def test_drf_share_floors_like_jax():
    """drs = -1 (the root lends nothing) divided by weights 500, 1000,
    3000 and 0: JAX's // floors, so weight 3000 gives -1, not C's 0; the
    same CQs under a root lending 3 units; a CQ without a cohort gets 0."""
    weights = np.array([500, 1000, 3000, 0, 500, 1000, 3000, 0, 1000],
                       np.int64)
    Qn = len(weights)
    topo = {
        "nominal": np.full((Qn, 1, 1), 1000, np.int64),
        "offered": np.ones((Qn, 1, 1), bool),
        "cq_cohort": np.array([0] * 4 + [1] * 4 + [-1], np.int32),
        "cohort_root": np.array([0, 1], np.int32),
        "cohort_lendable": np.array([[0], [3000]], np.int64),
        "fair_weight": weights,
    }
    usage = np.zeros((Qn, 1, 1), np.int64)
    asg = np.full((Qn, 1, 1), 5000, np.int64)   # borrows 4000
    wl_cq = np.arange(Qn, dtype=np.int32)
    ref = np.asarray(jk._drf_share({k: jnp.asarray(v) for k, v in topo.items()},
                                   jnp.asarray(usage), jnp.asarray(asg),
                                   jnp.asarray(wl_cq)))
    got = tk.drf_share({k: t(v) for k, v in topo.items()}, t(usage), t(asg),
                       t(wl_cq))
    assert_same(got, ref, "share")
    expected = [-2, -1, -1, tk.NO_LIMIT, 2666, 1333, 444, tk.NO_LIMIT, 0]
    assert got.tolist() == expected


@pytest.mark.parametrize("variant", ("drf", "mixed"))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_order_csr_with_shares(kind, seed, variant, monkeypatch):
    """The order with non-zero shares: drf_share's (held against the
    grid of the JAX fused program with fair sharing on), and a mix of
    ties, negative values and NO_LIMIT (held against the lexsort of the
    composite key)."""
    topo, usage, cu, wl = make_inputs(kind, seed)
    topo, wl = with_fair_sharing(topo, wl, seed)
    tt = torch_topo(topo)
    fit, borrows, _, _, asg = tk.phase_a(
        tt, tk.avail(tt, t(usage), t(cu)), t(usage),
        *(t(wl[k]) for k in ("requests", "podset_active", "wl_cq",
                             "eligible", "solvable")), P)
    if variant == "drf":
        share = tk.drf_share(tt, t(usage), asg, t(wl["wl_cq"]))
    else:
        rng = np.random.default_rng(seed)
        share = t(rng.choice(np.array([-2, -1, 0, 0, 125, 125, 333,
                                       tk.NO_LIMIT], np.int64), size=W))
    offsets, members, order = tk.order_csr(
        tt, fit, borrows, t(wl["priority"]), t(wl["timestamp"]),
        t(wl["wl_cq"]), share)
    assert order is None
    offsets, members = offsets.numpy(), members.numpy()
    if variant == "drf":
        grid, jfit, jborrows = fused_order_grid(topo, usage, cu, wl,
                                                monkeypatch, fair_sharing=True)
        np.testing.assert_array_equal(fit.numpy(), jfit)
        np.testing.assert_array_equal(borrows.numpy(), jborrows)
        for d in range(grid.shape[1]):
            col = grid[:, d]
            np.testing.assert_array_equal(members[offsets[d]:offsets[d + 1]],
                                          col[col >= 0], err_msg=f"domain {d}")
    share = share.numpy()
    assert (share != 0).any()
    q = wl["wl_cq"]
    cohort = topo["cq_cohort"][q]
    C = topo["cohort_subtree"].shape[0]
    domain = np.where(cohort >= 0, topo["cohort_root"][np.maximum(cohort, 0)],
                      C + q)
    ref = np.lexsort((np.arange(len(q)), wl["timestamp"], -wl["priority"],
                      share, borrows.numpy().astype(np.int32),
                      (~fit.numpy()).astype(np.int32), domain))
    np.testing.assert_array_equal(members, ref)


@pytest.mark.parametrize("variant", ("synth", "ties_padding"))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_order_csr_matches_fused_grid(kind, seed, variant, monkeypatch):
    topo, usage, cu, wl = make_inputs(kind, seed)
    if variant == "ties_padding":
        wl = with_ties_and_padding(wl, seed)
    grid, fit, borrows = fused_order_grid(topo, usage, cu, wl, monkeypatch)
    offsets, members, _ = tk.order_csr(torch_topo(topo), t(fit), t(borrows),
                                       t(wl["priority"]), t(wl["timestamp"]),
                                       t(wl["wl_cq"]))
    offsets, members = offsets.numpy(), members.numpy()
    D = grid.shape[1]
    assert offsets.shape == (D + 1,) and members.shape == (len(fit),)
    for d in range(D):
        col = grid[:, d]
        np.testing.assert_array_equal(members[offsets[d]:offsets[d + 1]],
                                      col[col >= 0], err_msg=f"domain {d}")
    # the composite key, written out: one stable sort
    q = wl["wl_cq"]
    cohort = topo["cq_cohort"][q]
    C = topo["cohort_subtree"].shape[0]
    domain = np.where(cohort >= 0, topo["cohort_root"][np.maximum(cohort, 0)],
                      C + q)
    ref = np.lexsort((np.arange(len(q)), wl["timestamp"], -wl["priority"],
                      np.zeros(len(q), np.int64), borrows.astype(np.int32),
                      (~fit).astype(np.int32), domain))
    np.testing.assert_array_equal(members, ref)


def random_corrections(topo, usage, seed, n):
    """n unique (q, f, r) coords of the offered quota with deltas that
    keep usage non-negative; several coords share cohort coords."""
    rng = np.random.default_rng(seed)
    cells = np.argwhere(topo["offered"])
    pick = cells[rng.choice(len(cells), size=min(n, len(cells)),
                            replace=False)]
    coords = []
    for q, f, r in pick:
        lo, hi = -int(usage[q, f, r]), int(topo["nominal"][q, f, r])
        dv = int(rng.integers(lo, hi + 1)) or 1000
        coords.append((int(q), int(f), int(r), dv))
    return coords


@pytest.mark.parametrize("n", (1, 7, 30))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_apply_state_deltas_matches_jax(kind, seed, n):
    topo, usage, cu, _ = make_inputs(kind, seed)
    coords = random_corrections(topo, usage, seed, n)
    ns_topo = SimpleNamespace(
        cq_index={f"cq{i}": i for i in range(Q)},
        flavor_index={f"f{i}": i for i in range(F)},
        resource_index={f"r{i}": i for i in range(R)},
        cq_chain=topo["cq_chain"], cohort_parent=topo["cohort_parent"],
        guaranteed=topo["guaranteed"],
        cohort_guaranteed=topo["cohort_guaranteed"])
    deltas = tenc.encode_deltas({(f"cq{q}", TorchFR(f"f{f}", f"r{r}")): v
                                 for q, f, r, v in coords}, ns_topo)
    ref_deltas = jenc.encode_deltas({(f"cq{q}", JaxFR(f"f{f}", f"r{r}")): v
                                     for q, f, r, v in coords}, ns_topo)
    for a, b in zip(deltas, ref_deltas):
        assert_same(a, b)
    assert (deltas[0] < 0).any()  # padding rows
    ref = jk.apply_state_deltas_impl(jax_topo(topo), jnp.asarray(usage),
                                     jnp.asarray(cu),
                                     *(jnp.asarray(a) for a in deltas))
    got_u, got_c = t(usage), t(cu)
    tk.apply_state_deltas(torch_topo(topo), got_u, got_c,
                          *(t(a) for a in deltas))
    assert_same(got_u, ref[0], "usage")
    assert_same(got_c, ref[1], "cohort_usage")
    assert not np.array_equal(got_u.numpy(), usage)
    mirror_u, mirror_c = usage.copy(), cu.copy()
    tenc.apply_deltas_np(ns_topo, mirror_u, mirror_c, deltas)
    assert_same(mirror_u, ref[0], "mirror usage")
    assert_same(mirror_c, ref[1], "mirror cohort_usage")


def arena_twin(seed, S=64, F_=5, R_=2):
    rng = np.random.default_rng(seed)
    return {
        "requests": rng.integers(0, 9000, size=(S, P, R_)).astype(np.int64),
        "podset_active": rng.uniform(size=(S, P)) < 0.6,
        "wl_cq": rng.integers(0, Q, size=S).astype(np.int32),
        "priority": rng.integers(-3, 4, size=S).astype(np.int64),
        "timestamp": rng.uniform(0, 100, size=S),
        "eligible": rng.uniform(size=(S, P, F_)) < 0.5,
        "solvable": rng.uniform(size=S) < 0.8,
    }


@pytest.mark.parametrize("D", (8, 512))
@pytest.mark.parametrize("seed", SEEDS)
def test_scatter_arena_rows_matches_jax(seed, D):
    rng = np.random.default_rng(seed + 100)
    twin = arena_twin(seed)
    S = twin["wl_cq"].shape[0]
    rows = {k: v[rng.integers(0, S, size=D)] for k, v in
            arena_twin(seed + 1).items()}
    n = min(D - 3, S)  # the arena pads with the out-of-range slot `cap`
    upd_slots = np.full(D, S, np.int32)
    upd_slots[:n] = rng.choice(S, size=n, replace=False)
    ref = jk.scatter_arena_rows_impl({k: jnp.asarray(v) for k, v in
                                      twin.items()}, jnp.asarray(upd_slots),
                                     {k: jnp.asarray(v) for k, v in
                                      rows.items()})
    got = {k: t(v) for k, v in twin.items()}
    tk.scatter_arena_rows(got, t(upd_slots), {k: t(v) for k, v in
                                              rows.items()})
    for k in tk.ARENA_FIELDS:
        assert_same(got[k], ref[k], k)


@pytest.mark.parametrize("seed", SEEDS)
def test_gather_arena_matches_jax(seed):
    rng = np.random.default_rng(seed + 200)
    twin = arena_twin(seed)
    slots = rng.integers(0, twin["wl_cq"].shape[0], size=W).astype(np.int32)
    slots[rng.uniform(size=W) < 0.2] = -1
    slots[-5:] = -1  # the padded tail of a batch
    ref = jk.gather_arena_impl({k: jnp.asarray(v) for k, v in twin.items()},
                               jnp.asarray(slots))
    got = tk.gather_arena({k: t(v) for k, v in twin.items()}, t(slots))
    for name, a, b in zip(tk.ARENA_FIELDS, got, ref):
        assert_same(a, b, name)


def test_topo_fields_match_jax():
    assert tk.TOPO_FIELDS == jk.TOPO_FIELDS
    assert tk.DECISION_KEYS == jk.DECISION_KEYS
    assert tk.MAX_COMPACT_FLAVORS == jk.MAX_COMPACT_FLAVORS


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 2, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tk.avail({}, meta, meta)
