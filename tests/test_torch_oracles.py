"""Parity of the port's remaining cycle programs with the JAX package.

The global W-step scan (kernel.solve_cycle, global_scan's plain version
on the CPU), the three-step cohort-parallel cycle
(solve_cycle_cohort_parallel), Phase A on its own (solve_phase_a), the
host order grid (build_order_grid) and Phase B over it
(solve_phase_b_domains), each against its JAX function on JAX-CPU with
x64, on the same seeded numpy inputs: the six seeds of
tests/test_solver.py's cohort-parallel check at its shape, flat cohorts
and nested trees 2 and 3 deep with CQs outside any cohort at 3 podsets, a
batch where no row fits, and a batch of one row; each with fair sharing
off, on (fair weights 0/500/1000/3000, roots that lend nothing), and
with flavor-resume ranks (start_rank). The port's solve_cycle is also
held to its solve_cycle_fused. Every output is int64 or bool, so every
comparison is exact equality.
"""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu.solver.synth import synth_solver_inputs
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver.synth import synth_start_rank
from tests.test_torch_kernels import (
    Q,
    WEIGHTS,
    WL_KEYS,
    assert_same,
    jax_topo,
    make_inputs,
    root_cohorts,
    t,
    torch_topo,
    with_ties_and_padding,
)

CYCLE_KEYS = ("admitted", "fit", "borrows", "chosen", "chosen_borrow",
              "usage", "cohort_usage")
PHASE_A_KEYS = ("fit", "borrows", "chosen", "chosen_borrow", "asg_usage",
                "share")
# (kind, seed): tests/test_solver.py:486-532's six seeds at its shape;
# make_inputs' flat and nested trees; no row fits; one row
CASES = ([("solver", s) for s in range(6)]
         + [(k, s) for k in ("flat", "nested2", "nested3") for s in (0, 1, 2)]
         + [("nonfit", 0), ("nonfit", 1), ("one", 0), ("one", 3)])
VARIANTS = ("plain", "fair", "start_rank")


def case_inputs(kind: str, seed: int, variant: str):
    """(topo, usage, cohort_usage, wl, num_podsets, start_rank) as numpy."""
    if kind == "solver":
        topo, usage, cu, wl = synth_solver_inputs(
            num_cqs=Q, num_cohorts=5, num_flavors=3, num_resources=2,
            num_workloads=64, seed=seed)
    else:
        topo, usage, cu, wl = make_inputs(
            "nested3" if kind in ("nonfit", "one") else kind, seed)
    if kind == "nonfit":
        # half the rows unencodable, the rest far over any quota
        wl["requests"] = wl["requests"] * 1000
        wl["solvable"][::2] = False
    elif kind == "one":
        wl = {k: v[:1].copy() for k, v in wl.items()}
        wl["solvable"][:] = True
    P = wl["requests"].shape[1]
    F = topo["nominal"].shape[1]
    start_rank = None
    if variant == "fair":
        rng = np.random.default_rng(seed + 100)
        topo["fair_weight"] = WEIGHTS[rng.integers(0, 4, size=Q)]
        lend = topo["cohort_lendable"].copy()
        roots = root_cohorts(topo)
        lend[roots[-1], 0] = 0
        if len(roots) > 1:
            lend[roots[0]] = 0
        topo["cohort_lendable"] = lend
        if wl["wl_cq"].shape[0] >= 16:
            wl = with_ties_and_padding(wl, seed)
    elif variant == "start_rank":
        start_rank = synth_start_rank(wl, F, seed)
    return topo, usage, cu, wl, P, start_rank


@functools.lru_cache(maxsize=None)
def reference(kind: str, seed: int, variant: str) -> dict:
    """The JAX package's outputs on the case, as numpy: solve_cycle,
    solve_cycle_cohort_parallel, solve_phase_a, build_order_grid on that
    Phase A and solve_phase_b_domains on that grid."""
    topo, usage, cu, wl, P, sr = case_inputs(kind, seed, variant)
    fair = variant == "fair"
    tj = jax_topo(topo)
    args = tuple(jnp.asarray(wl[k]) for k in WL_KEYS)
    sr_j = None if sr is None else jnp.asarray(sr)
    kw = dict(num_podsets=P, fair_sharing=fair, start_rank=sr_j)
    seq = jk.solve_cycle(tj, jnp.asarray(usage), jnp.asarray(cu), *args, **kw)
    par = jk.solve_cycle_cohort_parallel(
        tj, SimpleNamespace(**topo), jnp.asarray(usage), jnp.asarray(cu),
        *args, **kw)
    pa = jk.solve_phase_a(tj, jnp.asarray(usage), jnp.asarray(cu),
                          *(args[i] for i in (0, 1, 2, 5, 6)), **kw)
    pa = dict(zip(PHASE_A_KEYS, (np.asarray(a) for a in pa)))
    grid = jk.build_order_grid(
        pa["fit"], pa["borrows"], wl["priority"], wl["timestamp"],
        wl["wl_cq"], topo["cq_cohort"], topo["cohort_subtree"].shape[0],
        cohort_root=topo["cohort_root"], share=pa["share"] if fair else None)
    pb = jk.solve_phase_b_domains(
        tj, jnp.asarray(usage), jnp.asarray(cu), jnp.asarray(pa["asg_usage"]),
        jnp.asarray(pa["fit"]), jnp.asarray(wl["wl_cq"]), jnp.asarray(grid))
    return {"seq": {k: np.asarray(seq[k]) for k in CYCLE_KEYS},
            "par": {k: np.asarray(par[k]) for k in CYCLE_KEYS},
            "phase_a": pa, "grid": grid,
            "phase_b": tuple(np.asarray(a) for a in pb)}


def port_args(kind, seed, variant):
    topo, usage, cu, wl, P, sr = case_inputs(kind, seed, variant)
    return (topo, (torch_topo(topo), t(usage), t(cu),
                   *(t(wl[k]) for k in WL_KEYS)),
            dict(num_podsets=P, fair_sharing=variant == "fair",
                 start_rank=None if sr is None else t(sr)), wl)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind,seed", CASES)
def test_solve_cycle_matches_jax(kind, seed, variant):
    ref = reference(kind, seed, variant)["seq"]
    _, args, kw, _ = port_args(kind, seed, variant)
    got = tk.solve_cycle(*args, **kw)
    assert set(got) == set(CYCLE_KEYS)
    for k in CYCLE_KEYS:
        assert_same(got[k], ref[k], k)
    admitted = ref["admitted"]
    if kind == "nonfit":
        assert not ref["fit"].any()
    elif kind != "one":
        # the inputs reach both outcomes of the scan's re-check
        assert admitted.any() and not (admitted == ref["fit"]).all()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind,seed", CASES)
def test_cohort_parallel_matches_jax(kind, seed, variant):
    ref = reference(kind, seed, variant)
    topo, args, kw, _ = port_args(kind, seed, variant)
    got = tk.solve_cycle_cohort_parallel(args[0], topo, *args[1:], **kw)
    for k in CYCLE_KEYS:
        assert_same(got[k], ref["par"][k], k)
        # the JAX package's own equality: cohort-parallel == global scan
        assert_same(got[k], ref["seq"][k], k)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind,seed", CASES)
def test_solve_phase_a_matches_jax(kind, seed, variant):
    ref = reference(kind, seed, variant)["phase_a"]
    _, args, kw, _ = port_args(kind, seed, variant)
    got = tk.solve_phase_a(*args[:6], *args[8:], **kw)
    for k, a in zip(PHASE_A_KEYS, got):
        assert_same(a, ref[k], k)
    if variant == "fair" and kind not in ("nonfit", "one"):
        assert (ref["share"] != 0).any()
    if variant != "fair":
        assert not ref["share"].any()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind,seed", CASES)
def test_order_grid_and_phase_b_domains_match_jax(kind, seed, variant):
    """build_order_grid on the JAX Phase A's outputs, and
    solve_phase_b_domains on the JAX grid."""
    ref = reference(kind, seed, variant)
    topo, args, _, wl = port_args(kind, seed, variant)
    pa = ref["phase_a"]
    grid = tk.build_order_grid(
        pa["fit"], pa["borrows"], wl["priority"], wl["timestamp"],
        wl["wl_cq"], topo["cq_cohort"], topo["cohort_subtree"].shape[0],
        cohort_root=topo["cohort_root"],
        share=pa["share"] if variant == "fair" else None)
    assert_same(grid, ref["grid"], "grid")
    got = tk.solve_phase_b_domains(args[0], args[1], args[2],
                                   t(pa["asg_usage"]), t(pa["fit"]),
                                   t(wl["wl_cq"]), t(ref["grid"]))
    for name, a, b in zip(("admitted", "usage", "cohort_usage"), got,
                          ref["phase_b"]):
        assert_same(a, b, name)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind,seed", CASES)
def test_solve_cycle_matches_fused(kind, seed, variant):
    _, args, kw, _ = port_args(kind, seed, variant)
    seq = tk.solve_cycle(*args, **kw)
    fused = tk.solve_cycle_fused(*args, compact=False, **kw)
    assert set(fused) == set(CYCLE_KEYS)
    for k in CYCLE_KEYS:
        assert_same(seq[k], fused[k].numpy(), k)


def test_grid_csr_keeps_row_order_per_column():
    """A column's valid rows become its members in row order; padding
    (-1) anywhere in a column is dropped."""
    grid = np.array([[3, -1, 0], [5, -1, -1], [-1, 2, 4], [1, -1, -1]],
                    np.int32)
    offsets, members = tk.grid_csr(t(grid))
    assert offsets.tolist() == [0, 3, 4, 6]
    assert members.tolist() == [3, 5, 1, 2, 0, 4]
