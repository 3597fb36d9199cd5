"""The port's domain planner (kueue_tpu_torch/parallel/domains.py) against
the JAX package's (kueue_tpu/parallel/domains.py): on the same seeded
numpy inputs, every array, plan and fingerprint exactly equal. Cases:
LPT ties, zero weights, more bins than items, no items; plan_domains on
flat and nested topologies (padding rows included) at 1-8 ranks;
plan_problems' perm, inv and b_local."""

import numpy as np
import pytest

from kueue_tpu.parallel import domains as jd
from kueue_tpu_torch.parallel import domains as td
from kueue_tpu_torch.solver.synth import (synth_nested_inputs,
                                          synth_solver_inputs)

BINS = (1, 2, 3, 4, 8)


def weights_case(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return np.full(12, 3, np.int64)
    if kind == "zeros":
        w = rng.integers(0, 4, size=17)
        w[::3] = 0
        return w
    if kind == "few":  # fewer items than most bin counts
        return rng.integers(1, 9, size=3)
    if kind == "empty":
        return np.zeros(0, np.int64)
    return rng.integers(1, 50, size=41)


def assert_equal(got, ref):
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_equal(g, r)
        return
    if isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


@pytest.mark.parametrize("n_bins", BINS)
@pytest.mark.parametrize("kind", ("ties", "zeros", "few", "empty", "random"))
def test_partitions_match_jax(kind, n_bins):
    w = weights_case(kind, n_bins)
    for name in ("balanced_partition", "round_robin_partition"):
        got = getattr(td, name)(w, n_bins)
        ref = getattr(jd, name)(w, n_bins)
        assert_equal(got, ref)
        assert td.imbalance_ratio(got[1]) == jd.imbalance_ratio(ref[1])
    if kind == "ties" and n_bins > 1:
        # ties go to the lowest bin id, round after round
        bin_of, loads = td.balanced_partition(w, n_bins)
        assert bin_of.tolist()[:n_bins] == list(range(n_bins))


@pytest.mark.parametrize("n", (0, 1, 5, 9, 100))
def test_bucket_matches_jax(n):
    assert td._bucket(n) == jd._bucket(n)
    assert td._bucket(n, 4, 4) == jd._bucket(n, 4, 4)


def topology(kind: str, seed: int):
    if kind == "flat":
        topo, _, _, wl = synth_solver_inputs(
            num_cqs=24, num_cohorts=4, num_flavors=5, num_resources=2,
            num_workloads=40, num_podsets=2, seed=seed)
    elif kind == "cohortless":
        topo, _, _, wl = synth_solver_inputs(
            num_cqs=6, num_cohorts=1, num_flavors=3, num_resources=2,
            num_workloads=9, num_podsets=1, seed=seed)
        topo = dict(topo, cq_cohort=np.full(6, -1, np.int32))
    else:
        topo, _, _, wl = synth_nested_inputs(
            num_cqs=24, num_leaf_cohorts=4, fanout=2, depth=3, num_flavors=5,
            num_resources=2, num_workloads=40, num_podsets=2,
            no_cohort_every=5, seed=seed)
    rng = np.random.default_rng(seed)
    offered = topo["offered"].copy()
    offered[rng.random(offered.shape[:2]) < 0.3] = False  # flavor widths vary
    wl_cq = wl["wl_cq"].copy()
    wl_cq[-5:] = 0  # padding rows: CQ 0, as the encoder pads
    return wl_cq, topo["cq_cohort"], topo["cohort_root"], offered


@pytest.mark.parametrize("n", BINS)
@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("kind", ("flat", "nested", "cohortless"))
def test_plan_domains_matches_jax(kind, seed, n):
    args = topology(kind, seed)
    assert_equal(td.workload_domains(*args[:3]),
                 jd.workload_domains(*args[:3]))
    assert_equal(td.flavor_width(args[3]), jd.flavor_width(args[3]))
    got = td.plan_domains(*args, n)
    ref = jd.plan_domains(*args, n)
    for field in ("n_devices", "columns", "loads", "occupied", "imbalance",
                  "fingerprint", "d_cols"):
        assert_equal(getattr(got, field), getattr(ref, field))
    # every occupied domain on exactly one rank
    cols = got.columns[got.columns >= 0]
    assert len(cols) == len(set(cols.tolist())) == got.occupied


def test_fingerprint_follows_the_layout():
    args = topology("nested", 0)
    one, two = (td.plan_domains(*args, n).fingerprint for n in (2, 4))
    assert one != two
    assert td.plan_domains(*args, 2).fingerprint == one


@pytest.mark.parametrize("n", BINS)
@pytest.mark.parametrize("kind", ("ties", "zeros", "few", "empty", "random"))
def test_plan_problems_matches_jax(kind, n):
    w = weights_case(kind, 10 + n)
    got = td.plan_problems(w, n)
    ref = jd.plan_problems(w, n)
    assert_equal(got, ref)
    perm, inv, b_local = got
    assert len(perm) == n * b_local
    assert (perm[inv] == np.arange(len(w))).all()
    assert (perm[perm < len(w)].size == len(w))
