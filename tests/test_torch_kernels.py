"""Parity of the port's kernel module with the JAX package.

Each plain PyTorch version in kueue_tpu_torch.solver.kernel (the code a
wrapper runs for CPU tensors) against its JAX counterpart in
kueue_tpu.solver.kernel, on the same seeded numpy inputs: flat cohorts
from the JAX package's synth, hand-built nested trees of depth 2 and 3
with CQs outside any cohort, up to 3 podsets. Outputs are int64 and
bool, so every comparison is exact equality.

tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu.solver.synth import synth_solver_inputs
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver.synth import synth_nested_inputs, synth_start_rank

Q, F, R, W, P = 24, 5, 2, 40, 3
KINDS = ("flat", "nested2", "nested3")
SEEDS = (0, 1, 2)
WL_KEYS = ("requests", "podset_active", "wl_cq", "priority", "timestamp",
           "eligible", "solvable")


def make_inputs(kind: str, seed: int):
    if kind == "flat":
        topo, usage, cu, wl = synth_solver_inputs(
            num_cqs=Q, num_cohorts=4, num_flavors=F, num_resources=R,
            num_workloads=W, num_podsets=P, seed=seed)
    else:
        topo, usage, cu, wl = synth_nested_inputs(
            num_cqs=Q, num_leaf_cohorts=4, fanout=2, depth=int(kind[-1]),
            num_flavors=F, num_resources=R, num_workloads=W, num_podsets=P,
            no_cohort_every=5, seed=seed)
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


@pytest.mark.parametrize("compact", (True, False))
@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("kind", KINDS)
def test_solve_cycle_fused_matches_jax(kind, seed, compact):
    topo, usage, cu, wl = make_inputs(kind, seed)
    start_rank = synth_start_rank(wl, F, seed) if compact else None
    max_rank = jk.max_rank_bound(wl["wl_cq"], topo["cq_cohort"],
                                 topo["cohort_root"])
    assert tk.max_rank_bound(wl["wl_cq"], topo["cq_cohort"],
                             topo["cohort_root"]) == max_rank
    ref = jk.solve_cycle_fused(
        jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu),
        *(jnp.asarray(wl[k]) for k in WL_KEYS), num_podsets=P,
        max_rank=max_rank,
        start_rank=None if start_rank is None else jnp.asarray(start_rank),
        compact=compact)
    got = tk.solve_cycle_fused(
        torch_topo(topo), t(usage), t(cu), *(t(wl[k]) for k in WL_KEYS),
        num_podsets=P, max_rank=max_rank,
        start_rank=None if start_rank is None else t(start_rank),
        compact=compact)
    assert set(got) == set(ref)
    for k in ref:
        assert_same(got[k], ref[k], k)


def test_topo_fields_match_jax():
    assert tk.TOPO_FIELDS == jk.TOPO_FIELDS
    assert tk.DECISION_KEYS == jk.DECISION_KEYS
    assert tk.MAX_COMPACT_FLAVORS == jk.MAX_COMPACT_FLAVORS


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 2, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tk.avail({}, meta, meta)
