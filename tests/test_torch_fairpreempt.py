"""The port's fair-sharing preemption path against the JAX package's.

On the same inputs, made from seeds, exactly equal (int64, int8 and
bits):

- the candidate views of solver/candidates.py: `all_frs` and
  `share_view` of every conflict domain, on snapshots of seeded
  fair-sharing scenarios;
- the encode (solver/fairpreempt.py build_fair_problems +
  encode_fair_problems, fair_args): every array of the FairBatch and of
  the minimal batch beside it; the solve on those batches and
  decode_fair_targets' (workload, reason) lists;
- solve_fair_plain against solve_fair_impl on synthetic batches
  (synth.synth_fair_inputs): every strategy order, weight 0, roots
  lending nothing in a resource (drs -1), borrowing outside the slots
  (base_other, floor_ratio, floor_any), the borrowWithinCohort
  threshold, a flat forest and trees 2 and 3 deep with CQs attached at
  two depths, padding problems, fill-back, and retry passes that remove;
- the cycle compositions with fair_preempt_args (with and without
  preempt_args): solve_cycle_with_preempt, the resident cycle (with a
  delta prologue) and the arena cycle against their JAX programs;
- BatchSolver.solve_preemptions: K9 and K11 back to back with one sync,
  equal to each alone.

tests/test_torch_cuda.py holds the CUDA kernel against the plain
version on the card; tests/test_torch_scheduler.py the port's Scheduler
with fair sharing and device preemption against the JAX Scheduler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu.scheduler import flavorassigner as jfa
from kueue_tpu.solver import candidates as jcand
from kueue_tpu.solver import encode as jenc
from kueue_tpu.solver import fairpreempt as jfp
from kueue_tpu.solver import preempt as jpre
from kueue_tpu_torch.scheduler import flavorassigner as tfa
from kueue_tpu_torch.scheduler.preemption import parse_strategies
from kueue_tpu_torch.solver import candidates as tcand
from kueue_tpu_torch.solver import encode as tenc
from kueue_tpu_torch.solver import fairpreempt as tfp
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver import preempt as tpre
from kueue_tpu_torch.solver.synth import (synth_deltas, synth_fair_inputs,
                                          synth_fair_problems,
                                          synth_preempt_problems)
from tests.test_torch_kernels import (P, WL_KEYS, assert_same, jax_topo,
                                      make_inputs, t, torch_topo)
from tests.test_torch_preempt import frs_key
from tests.test_torch_scheduler import (PKGS, Env, fair_cohort,
                                        mixed_setup, random_fair_scenario,
                                        uneven_borrowers, with_existing,
                                        cpu_workloads)

# (strategy 0 is S2-a, a retry pass exists, strategy 1 is S2-a): the
# default S2-a then S2-b, S2-a alone, S2-b alone, S2-b then S2-a
STRATS = ((True, True, False), (True, False, False), (False, False, False),
          (False, True, True))
STRAT_IDS = ("default", "s2a", "s2b", "reversed")
OUTPUTS = ("targets", "feasible", "reasons", "stats")
_SOLVE = {}


def jax_fair(topo, usage, cu, args, strat):
    fn = _SOLVE.get(strat)
    if fn is None:
        fn = _SOLVE[strat] = jax.jit(
            lambda tp, u, c, *a: jfp.solve_fair_impl(tp, u, c, *a,
                                                     strat=strat))
    return [np.asarray(x) for x in fn(jax_topo(topo), jnp.asarray(usage),
                                      jnp.asarray(cu),
                                      *(jnp.asarray(a) for a in args))]


def port_fair(topo, usage, cu, args, strat):
    return [x.numpy() for x in tk.solve_fair(
        torch_topo(topo), t(usage), t(cu), *(t(a) for a in args),
        strat=strat)]


SYNTH = dict(max_local_cqs=4, num_cqs=48, num_flavors=3)


# --- K11: the plain version against solve_fair_impl ---

@pytest.mark.parametrize("strat", STRATS, ids=STRAT_IDS)
@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("depth", (1, 2, 3))
def test_solve_fair_matches_jax(depth, seed, strat):
    topo, usage, cu, args = synth_fair_inputs(40, 24, depth=depth, seed=seed,
                                              **SYNTH)
    ref = jax_fair(topo, usage, cu, args, strat)
    got = port_fair(topo, usage, cu, args, strat)
    for name, a, b in zip(OUTPUTS, got, ref):
        assert_same(a, b, name)
    targets, feasible, reasons, stats = got
    assert feasible[:40].any() and not feasible[:40].all()
    assert not targets[~feasible].any()
    # padding problems keep the outputs' defaults
    assert not targets[40:].any() and not feasible[40:].any()
    assert not reasons[40:].any() and not stats[40:].any()


def test_solve_fair_inputs_reach_every_branch():
    """Over the seeded batches above: weight 0, roots lending nothing,
    borrowing outside the slots, thresholds, chains with a node at two
    depths; every reason code; the fill-back returns candidates; and the
    retry pass removes (the same batch without it gives other targets)."""
    reasons_seen, filled, retry_changed = set(), 0, 0
    weight0 = lend0 = floor = base = shared_depth = 0
    for depth in (1, 2, 3):
        for seed in (0, 1):
            topo, usage, cu, args = synth_fair_inputs(
                40, 24, depth=depth, seed=seed, **SYNTH)
            (gq, gf, gr, gc, chain, req, frs, cidx, cql, tab_u, tab_p, tha,
             th, hc, rank, count, order, base_o, floor_r, floor_a, weight,
             lend) = args
            weight0 += int((weight[gq >= 0] == 0).sum())
            lend0 += int(((lend == 0) & (gf >= 0)).sum())
            floor += int(floor_a.sum())
            base += int((base_o > 0).sum())
            dep = topo["cohort_depth"]
            for b in range(40):
                nodes = {}
                for q in range(gq.shape[1]):
                    for d in range(chain.shape[2]):
                        c = chain[b, q, d]
                        if c >= 0:
                            nodes.setdefault(int(gc[b, c]), set()).add(d)
                shared_depth += any(len(v) > 1 for v in nodes.values())
            assert (dep >= 0).all()
            full = port_fair(topo, usage, cu, args, STRATS[0])
            alone = port_fair(topo, usage, cu, args, STRATS[1])
            targets, feasible, reasons, stats = full
            reasons_seen |= set(np.unique(reasons[targets]).tolist())
            filled += int(stats[:, 3].sum())
            retry_changed += int((full[0] != alone[0]).any(1).sum())
            assert tha.any()
    assert reasons_seen == {0, 1, 2}
    assert filled > 0 and retry_changed > 0
    assert weight0 and lend0 and floor and base
    assert shared_depth > 0


def test_share_floors_negative_drs():
    """A CQ borrowing in a resource its root lends nothing of has ratio
    -1, so drs is -1 and its share -1000 // weight, floored: -1 at weight
    3000, -2 at 500 (C's truncation would give 0)."""
    one = torch.ones((1, 1), dtype=torch.int64)
    u = torch.tensor([[[5000, 0]]])
    nom = torch.tensor([[[4000, 0]]])
    valid = torch.tensor([[True, False]])
    same = torch.tensor([[[True, False], [False, False]]])
    for w, want in ((3000, -1), (500, -2), (1000, -1), (0, tk.MAXSHARE)):
        got = tk._share_rows(u, nom, torch.zeros_like(u), -one,
                             torch.zeros((1, 1), dtype=torch.bool), w * one,
                             torch.zeros((1, 2), dtype=torch.int64), valid,
                             same)
        assert int(got) == want, w


# --- the candidate views, the encode and the decode ---

def fair_scenario_envs(seed):
    """Both packages' Envs of a fair-sharing scenario: a
    random_fair_scenario seed, "uneven" (four CQs, one heavy borrower)
    or "mixed" (a minimal and a fair problem in one cohort)."""
    if seed == "uneven":
        setup, workloads = (with_existing(fair_cohort(), uneven_borrowers),
                            lambda: cpu_workloads(
                                [("inc", "cq3", 5, 100.0, "2")]))
    elif seed == "mixed":
        setup, workloads = mixed_setup, lambda: cpu_workloads(
            [("own-high", "own", 10, 100.0, "3"),
             ("claimant", "claim", 5, 101.0, "4")])
    else:
        setup, workloads, _ = random_fair_scenario(seed)
    envs = []
    for pkg in PKGS:
        env = Env(pkg, "device", fair_sharing=True, preempt="device")
        setup(env)
        for w in workloads():
            env.submit(w)
        envs.append(env)
    return envs


MODS = {"kueue_tpu": (jcand, jfp, jpre, jenc, jfa),
        "kueue_tpu_torch": (tcand, tfp, tpre, tenc, tfa)}
FAIR_SEEDS = (1, 2, 4, 5, 6, "uneven", "mixed")


@pytest.mark.parametrize("seed", FAIR_SEEDS)
def test_share_view_matches_jax(seed):
    envs = fair_scenario_envs(seed)
    snaps = [env.cache.snapshot() for env in envs]
    idx = [MODS[env.pkg][0].candidate_index(snap, env.scheduler.ordering,
                                            1000.0)
           for env, snap in zip(envs, snaps)]
    views = 0
    for name in sorted(snaps[0].cluster_queues):
        doms = [ix.domain_for(s.cluster_queues[name])
                for ix, s in zip(idx, snaps)]
        frs = [d.all_frs() for d in doms]
        assert frs_key(frs[1]) == frs_key(frs[0])
        for pick in (slice(None), slice(0, 1)):
            slots = [tuple(sorted(f))[pick] for f in frs]
            want, got = (d.share_view(s) for d, s in zip(doms, slots))
            assert set(got) == set(want)
            for k in want:
                assert_same(got[k], want[k], k)
            views += 1
    assert views


def encode_both(envs):
    """Each package's preempt-mode heads of the envs' first cycle (popped
    from the queues), build_fair_problems, encoded: [(minimal batch or
    None, fair batch or None, topo, snapshot, entry -> CQ, heads)] (JAX
    first)."""
    out = []
    for env in envs:
        cand, fp, pre, enc, fa = MODS[env.pkg]
        snap = env.cache.snapshot()
        ix = cand.candidate_index(snap, env.scheduler.ordering, 1000.0)
        mins, fairs, req_by, frs_by, cq_by = [], [], {}, {}, {}
        i = 0
        heads = env.queues.heads_nonblocking()
        for w in heads:
            a, _ = env.scheduler.get_assignments(w, snap,
                                                 defer_preemption=True)
            if a.representative_mode() != fa.PREEMPT:
                continue
            req_by[i] = a.total_requests_for(w)
            frs_by[i] = fa.flavor_resources_need_preemption(a)
            cq_by[i] = w.cluster_queue
            m, f = fp.build_fair_problems(i, w, req_by[i], frs_by[i], snap,
                                          env.scheduler.preemptor, ix)
            mins += m
            fairs += f
            i += 1
        topo = enc.encode_topology(snap)
        out.append((pre.encode_problems(mins, snap, topo, req_by, cq_by,
                                        frs_by) if mins else None,
                    fp.encode_fair_problems(fairs, snap, topo, req_by, cq_by,
                                            frs_by) if fairs else None,
                    topo, snap, cq_by, heads))
    return out


FAIR_FIELDS = ("gq", "gf", "gr", "gc", "chain_local", "requests", "frs_np",
               "cand_idx", "cand_ql", "cand_usage", "cand_prio",
               "threshold_active", "threshold", "has_cohort", "cand_rank",
               "cq_count", "cq_order", "base_other", "floor_ratio",
               "floor_any", "weight", "lendable")


@pytest.mark.parametrize("seed", FAIR_SEEDS)
def test_encode_solve_decode_match_jax(seed):
    envs = fair_scenario_envs(seed)
    (jmin, jfair, jtopo, jsnap, jcq, _), (tmin, tfair, ttopo, tsnap, tcq,
                                          _) = encode_both(envs)
    assert (jfair is None) == (tfair is None)
    assert (jmin is None) == (tmin is None)
    assert jfair is not None or jmin is not None
    if seed == "mixed":
        assert jfair is not None and jmin is not None
    if jmin is not None:
        for name, a, b in zip(FAIR_FIELDS, tpre.preempt_args(tmin),
                              jpre.preempt_args(jmin)):
            assert_same(a, b, f"minimal {name}")
    if jfair is None:
        return
    assert [p.num_candidates for p in tfair.problems] == \
        [p.num_candidates for p in jfair.problems]
    for name, a, b in zip(FAIR_FIELDS, tfp.fair_args(tfair),
                          jfp.fair_args(jfair)):
        assert_same(a, b, name)
    jstate = jenc.encode_state(jsnap, jtopo)
    tstate = tenc.encode_state(tsnap, ttopo)
    flags = [fp.strategy_flags(env.scheduler.preemptor.fs_strategies)
             for fp, env in zip((jfp, tfp), envs)]
    assert flags[1] == flags[0]
    ref = jax_fair({k: getattr(jtopo, k) for k in jk.TOPO_FIELDS},
                   jstate.usage, jstate.cohort_usage, jfp.fair_args(jfair),
                   flags[0])
    got = port_fair({k: getattr(ttopo, k) for k in tk.TOPO_FIELDS},
                    tstate.usage, tstate.cohort_usage, tfp.fair_args(tfair),
                    flags[1])
    for name, a, b in zip(OUTPUTS, got, ref):
        assert_same(a, b, name)
    decoded = [fp.decode_fair_targets(b, *out[:3], snap, cq)
               for fp, b, out, snap, cq in ((jfp, jfair, ref, jsnap, jcq),
                                            (tfp, tfair, got, tsnap, tcq))]
    flat = [{i: [(x.workload_info.key, x.reason) for x in ts]
             for i, ts in d.items()} for d in decoded]
    assert flat[1] == flat[0]


@pytest.mark.parametrize("names", (None, ["LessThanOrEqualToFinalShare"],
                                   ["LessThanInitialShare"],
                                   ["LessThanInitialShare",
                                    "LessThanOrEqualToFinalShare"]))
def test_strategy_flags(names):
    """strategy_flags reads the port's own strategy functions."""
    from kueue_tpu.scheduler.preemption import parse_strategies as jparse
    assert tfp.strategy_flags(parse_strategies(names)) == \
        jfp.strategy_flags(jparse(names))


# --- the cycle compositions with fair_preempt_args ---

@pytest.mark.parametrize("with_minimal", (False, True))
@pytest.mark.parametrize("cycle", ("fused", "resident", "arena"))
def test_cycles_with_fair_preempt_match_jax(cycle, with_minimal):
    topo, usage, cu, wl_ = make_inputs("nested3", 1)
    fargs = tfp.fair_args(synth_fair_problems(topo, 10, 16, seed=5))
    pargs = tpre.preempt_args(synth_preempt_problems(topo, 10, 16, seed=5)) \
        if with_minimal else None
    deltas = synth_deltas(topo, usage, 12, seed=5)
    strat = STRATS[0]
    kw = dict(num_podsets=P, max_rank=64, compact=True)
    jbatch = [jnp.asarray(wl_[k]) for k in WL_KEYS]
    tbatch = [t(wl_[k]) for k in WL_KEYS]
    jp = None if pargs is None else tuple(jnp.asarray(a) for a in pargs)
    tp = None if pargs is None else tuple(t(a) for a in pargs)
    jf = tuple(jnp.asarray(a) for a in fargs)
    tf = tuple(t(a) for a in fargs)
    fair = dict(fair_preempt_args=None, fs_strategies=strat)
    if cycle == "fused":
        ref = jk.solve_cycle_with_preempt_impl(
            jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu), *jbatch, jp,
            **kw, **dict(fair, fair_preempt_args=jf))
        got = tk.solve_cycle_with_preempt(
            torch_topo(topo), t(usage), t(cu), *tbatch, tp, **kw,
            **dict(fair, fair_preempt_args=tf))
    elif cycle == "resident":
        ref = jk.solve_cycle_resident_impl(
            jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu),
            tuple(jnp.asarray(a) for a in deltas), *jbatch, preempt_args=jp,
            **kw, **dict(fair, fair_preempt_args=jf))
        got = tk.solve_cycle_resident(
            torch_topo(topo), t(usage), t(cu), tuple(t(a) for a in deltas),
            *tbatch, preempt_args=tp, **kw,
            **dict(fair, fair_preempt_args=tf))
    else:
        slots = np.arange(wl_["wl_cq"].shape[0], dtype=np.int32)[::-1].copy()
        slots[-3:] = -1
        ref = jk.solve_cycle_resident_arena_impl(
            jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu), None,
            {k: jnp.asarray(wl_[k]) for k in WL_KEYS}, jnp.asarray(slots),
            preempt_args=jp, **kw, **dict(fair, fair_preempt_args=jf))
        got = tk.solve_cycle_resident_arena(
            torch_topo(topo), t(usage), t(cu), None,
            {k: t(wl_[k]) for k in WL_KEYS}, t(slots), preempt_args=tp,
            **kw, **dict(fair, fair_preempt_args=tf))
    assert set(got) == set(ref)
    assert ("preempt_targets" in got) == with_minimal
    for k in ref:
        assert_same(got[k], ref[k], k)
    assert np.asarray(ref["fair_feasible"]).any()


# --- the solver: K9 and K11 after the cycle, one sync ---

def test_solve_preemptions_one_sync():
    """solve_preemptions launches K9 and K11 back to back after the
    cycle's sync with one sync and one fetch for both; each half equals
    the same solve alone, and the cycle's solve_prepared gives the same
    targets in its own dispatch."""
    env = fair_scenario_envs("mixed")[1]
    (pb, fb, topo, snap, cq_by, heads), = encode_both([env])
    solver = env.scheduler.solver
    flags = tfp.strategy_flags(env.scheduler.preemptor.fs_strategies)
    plan = solver.prepare(snap, heads)
    decisions, aux = solver.solve_prepared(plan, snap, preempt_batch=pb,
                                           fair_batch=fb, fs_flags=flags)
    before = solver.counters["syncs"]
    fetched = solver.counters["fetch_bytes"]
    both = solver.solve_preemptions(pb, fb, flags)
    assert solver.counters["syncs"] == before + 1
    assert solver.counters["fetch_bytes"] - fetched == sum(
        a.nbytes for k in ("preempt", "fair") for a in both[k]) + \
        both["preempt_stats"].nbytes + both["fair_stats"].nbytes
    fair_only = solver.solve_preemptions(None, fb, flags)
    minimal_only = solver.solve_preempt(pb)
    assert set(fair_only) == {"fair", "fair_stats"}
    for a, b in zip(both["fair"] + (both["fair_stats"],),
                    fair_only["fair"] + (fair_only["fair_stats"],)):
        assert_same(a, b)
    for a, b in zip(both["preempt"] + (both["preempt_stats"],),
                    minimal_only):
        assert_same(a, b)
    for k in ("preempt", "fair"):
        for a, b in zip(aux[k], both[k]):
            assert_same(a, b, k)
    assert both["fair"][1][0] and both["preempt"][1][0]
    assert solver.solve_preemptions(None, None) is None
