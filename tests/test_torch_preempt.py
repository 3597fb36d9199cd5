"""The port's minimal-preemption path against the JAX package's.

On the same inputs, made from seeds, exactly equal (int64 and bits):

- the candidate index (solver/candidates.py): each conflict domain's
  candidate order and every select() mask, on snapshots of seeded random
  scenarios with nested cohorts (tests/test_preempt_batched.py's);
- the problem encode (solver/preempt.py build_problems +
  encode_problems): every array of the PreemptionBatch; the solve on
  that batch and decode_targets' (workload, reason) lists;
- solve_preempt_plain against solve_preempt_impl on synthetic batches:
  a flat cohort forest and trees 2 and 3 deep with CQs attached at two
  depths, within-CQ, reclaim and threshold problems, problems with no
  candidates or no fitting prefix, and padding problems; and the
  invariant the CUDA kernel's slot compaction rests on (a slot with no
  request and no needs-preemption flag changes no output), on both;
- the cycle compositions with preempt_args: solve_cycle_with_preempt,
  the resident cycle (with a delta prologue) and the arena cycle against
  their JAX programs;
- the state from before the cycle: BatchSolver.solve_preempt after a
  cycle that admits into the preemptor's CQ reads the usage the cycle
  read, not the usage Phase B left (which would give other targets).

tests/test_torch_cuda.py holds the CUDA kernel against the plain version
on the card; tests/test_torch_scheduler.py the port's Scheduler with
device preemption against the JAX Scheduler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu.core.resources import FlavorResource as JaxFR
from kueue_tpu.scheduler import flavorassigner as jfa
from kueue_tpu.solver import candidates as jcand
from kueue_tpu.solver import encode as jenc
from kueue_tpu.solver import preempt as jpre
from kueue_tpu_torch.core.resources import FlavorResource as TorchFR
from kueue_tpu_torch.scheduler import flavorassigner as tfa
from kueue_tpu_torch.solver import candidates as tcand
from kueue_tpu_torch.solver import encode as tenc
from kueue_tpu_torch.solver import fairpreempt as tfp
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver import preempt as tpre
from kueue_tpu_torch.solver.service import BatchSolver, preempt_aux
from kueue_tpu_torch.solver.synth import (synth_deltas, synth_preempt_inputs,
                                          synth_preempt_problems)
from tests.test_torch_kernels import (P, WL_KEYS, assert_same, jax_topo,
                                      make_inputs, t, torch_topo)
from tests.test_torch_scheduler import (PKGS, PREEMPT_SEEDS, Env, one_cq,
                                        random_preempt_scenario, reclaim_env,
                                        set_preempt_gate, wl, with_existing)

SOLVE = jax.jit(jpre.solve_preempt_impl)
OUTPUTS = ("targets", "feasible", "stats")
# each package's modules, JAX first
MODS = {"kueue_tpu": (jcand, jpre, jenc, jfa, JaxFR),
        "kueue_tpu_torch": (tcand, tpre, tenc, tfa, TorchFR)}


def jax_solve(topo, usage, cu, args):
    return [np.asarray(x) for x in SOLVE(jax_topo(topo), jnp.asarray(usage),
                                         jnp.asarray(cu),
                                         *(jnp.asarray(a) for a in args))]


def port_solve(topo, usage, cu, args):
    return [x.numpy() for x in tk.solve_preempt(
        torch_topo(topo), t(usage), t(cu), *(t(a) for a in args))]


# --- K9: the plain version against solve_preempt_impl ---

@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("depth", (1, 2, 3))
def test_solve_preempt_matches_jax(depth, seed):
    topo, usage, cu, args = synth_preempt_inputs(
        13, 20, depth=depth, num_cqs=32, num_flavors=2, seed=seed)
    ref = jax_solve(topo, usage, cu, args)
    got = port_solve(topo, usage, cu, args)
    for name, a, b in zip(OUTPUTS, got, ref):
        assert_same(a, b, name)
    targets, feasible, stats = got
    threshold_active = args[12]
    # the batch reaches what the kernel must get right
    assert feasible[:13].any() and not feasible[:13].all()
    assert threshold_active.any()
    assert stats[:13, 2].max() >= 2          # more than one auction round
    # padding problems: nothing to remove, one round
    assert not targets[13:].any() and not feasible[13:].any()
    assert (stats[13:] == [0, 0, 1, 0]).all()


@pytest.mark.parametrize("seed", (1, 2))
@pytest.mark.parametrize("depth", (1, 2, 3))
def test_inactive_slots_change_no_output(depth, seed):
    """What the CUDA kernel's slot compaction rests on: a slot with no
    request and no needs-preemption flag changes no output. Made a
    padding slot (gf = -1, gr = 0), the JAX program and the plain version
    give the targets, feasible and stats of the untouched batch."""
    topo, usage, cu, args = synth_preempt_inputs(
        40, 20, depth=depth, num_cqs=32, num_flavors=2, num_resources=3,
        seed=seed)
    gf, gr, req, frs = args[1], args[2], args[5], args[6]
    off = (gf >= 0) & (req <= 0) & ~frs
    assert off.any()  # the batch has such slots
    cut = list(args)
    cut[1] = np.where(off, -1, gf).astype(gf.dtype)
    cut[2] = np.where(off, 0, gr).astype(gr.dtype)
    ref = jax_solve(topo, usage, cu, args)
    assert ref[1][:40].any()
    for got in (jax_solve(topo, usage, cu, cut),
                port_solve(topo, usage, cu, cut),
                port_solve(topo, usage, cu, args)):
        for name, a, b in zip(OUTPUTS, got, ref):
            assert_same(a, b, name)


def test_preempt_args_carry_active_slots():
    """preempt_args counts the batch's active slots once, from the host
    arrays (the most slots with a request or a needs-preemption flag in
    any problem), keeps the count across map(), and
    kernel.solve_preemptions, which hands it to solve_preempt, gives the
    JAX program's outputs."""
    topo, usage, cu, args = synth_preempt_inputs(
        13, 20, depth=2, num_cqs=32, num_flavors=2, num_resources=3, seed=4)
    per = ((args[5] > 0) | args[6]).sum(1)
    assert isinstance(args, tpre.PreemptArgs)
    assert args.active_slots == per.max() == 3 < args[1].shape[1]
    up = args.map(t)
    assert up.active_slots == 3 and all(
        np.array_equal(u.numpy(), a) for u, a in zip(up, args))
    out = tk.solve_preemptions(torch_topo(topo), t(usage), t(cu), up)
    ref = jax_solve(topo, usage, cu, args)
    for name, a, b in zip(OUTPUTS, ref, (out["preempt_targets"],
                                          out["preempt_feasible"],
                                          out["preempt_stats"])):
        assert_same(b.numpy(), a, name)


def test_preempt_aux_refuses_unsized_rows():
    """A K9 stats row of -1 (a problem with more active slots than the
    launch was sized for) raises in preempt_aux; rows of real outcomes and
    padding problems pass."""
    fetched = {"preempt_targets": np.zeros((3, 8), bool),
               "preempt_feasible": np.array([True, False, False]),
               "preempt_stats": np.array([[4, 2, 1, 0], [0, 0, 1, 0],
                                          [3, 0, 1, 0]], np.int32)}
    aux = preempt_aux(fetched)
    assert aux["preempt_stats"] is fetched["preempt_stats"]
    fetched["preempt_stats"][2] = -1
    with pytest.raises(RuntimeError, match=r"problems \[2\]"):
        preempt_aux(fetched)


def test_solve_preempt_fills_back():
    """Over the seeded batches the fill-back returns candidates (stats
    column 3), a candidate is never both returned and a target, and an
    infeasible problem has no targets."""
    filled = 0
    for depth in (1, 2, 3):
        for seed in (0, 1):
            topo, usage, cu, args = synth_preempt_inputs(
                13, 20, depth=depth, num_cqs=32, num_flavors=2, seed=seed)
            targets, feasible, stats = port_solve(topo, usage, cu, args)
            filled += int(stats[:, 3].sum())
            assert not targets[~feasible].any()
            assert (targets.sum(1) + stats[:, 3] <= stats[:, 1]).all()
    assert filled > 0


# --- the cycle compositions with preempt_args ---

@pytest.mark.parametrize("cycle", ("fused", "resident", "arena"))
def test_cycles_with_preempt_match_jax(cycle):
    topo, usage, cu, wl_ = make_inputs("nested3", 1)
    pargs = tpre.preempt_args(synth_preempt_problems(topo, 10, 16, seed=5))
    deltas = synth_deltas(topo, usage, 12, seed=5)
    kw = dict(num_podsets=P, max_rank=64, compact=True)
    jbatch = [jnp.asarray(wl_[k]) for k in WL_KEYS]
    tbatch = [t(wl_[k]) for k in WL_KEYS]
    jp = tuple(jnp.asarray(a) for a in pargs)
    tp = tuple(t(a) for a in pargs)
    if cycle == "fused":
        ref = jk.solve_cycle_with_preempt_impl(
            jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu), *jbatch, jp,
            **kw)
        got = tk.solve_cycle_with_preempt(torch_topo(topo), t(usage), t(cu),
                                          *tbatch, tp, **kw)
    elif cycle == "resident":
        ref = jk.solve_cycle_resident_impl(
            jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu),
            tuple(jnp.asarray(a) for a in deltas), *jbatch, preempt_args=jp,
            **kw)
        got = tk.solve_cycle_resident(
            torch_topo(topo), t(usage), t(cu), tuple(t(a) for a in deltas),
            *tbatch, preempt_args=tp, **kw)
    else:
        slots = np.arange(wl_["wl_cq"].shape[0], dtype=np.int32)[::-1].copy()
        slots[-3:] = -1
        ref = jk.solve_cycle_resident_arena_impl(
            jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu), None,
            {k: jnp.asarray(wl_[k]) for k in WL_KEYS}, jnp.asarray(slots),
            preempt_args=jp, **kw)
        got = tk.solve_cycle_resident_arena(
            torch_topo(topo), t(usage), t(cu), None,
            {k: t(wl_[k]) for k in WL_KEYS}, t(slots), preempt_args=tp, **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert_same(got[k], ref[k], k)
    assert np.asarray(ref["preempt_feasible"]).any()


# --- the candidate index, the encode and the decode ---

def scenario_envs(seed):
    """Both packages' Envs of a scenario: a random_preempt_scenario seed,
    or "reclaim": the reclaim configuration after its first cycle (the
    lenders' reclaims across 2-deep cohort trees and the borrowers'
    within-CQ problems)."""
    if seed == "reclaim":
        envs = [reclaim_env(pkg, "device") for pkg in PKGS]
        for env in envs:
            set_cpu_gate(env)
            env.cycle()
        return envs
    setup, workloads = random_preempt_scenario(seed)
    envs = []
    for pkg in PKGS:
        env = Env(pkg, "device", preempt="device")
        setup(env)
        for w in workloads():
            env.submit(w)
        envs.append(env)
    return envs


def set_cpu_gate(env):
    set_preempt_gate(env.scheduler, env.pkg, "cpu")


def preempt_mode_heads(env, snapshot):
    """The heads whose assignment needs preemption, with their requests,
    needs-preemption FlavorResources and CQ, by entry index."""
    fa = MODS[env.pkg][3]
    out = []
    for w in env.queues.heads_nonblocking():
        a, targets = env.scheduler.get_assignments(w, snapshot,
                                                   defer_preemption=True)
        if a.representative_mode() == fa.PREEMPT:
            out.append((w, a.total_requests_for(w),
                        fa.flavor_resources_need_preemption(a)))
    return out


def frs_key(frs):
    return sorted((fr.flavor, fr.resource) for fr in frs)


@pytest.mark.parametrize("seed", (*PREEMPT_SEEDS[:4], "reclaim"))
def test_candidates_encode_decode_match_jax(seed):
    envs = scenario_envs(seed)
    snaps = [env.cache.snapshot() for env in envs]
    mods = [MODS[env.pkg] for env in envs]
    idx = [m[0].candidate_index(snap, env.scheduler.ordering, 1000.0)
           for m, snap, env in zip(mods, snaps, envs)]
    # every domain's order, and select() under every policy combination
    for name in sorted(snaps[0].cluster_queues):
        doms = [ix.domain_for(s.cluster_queues[name])
                for ix, s in zip(idx, snaps)]
        assert doms[1].cq_names == doms[0].cq_names
        assert_same(doms[1].order, doms[0].order, "order")
        assert_same(doms[1].prio, doms[0].prio, "prio")
        assert_same(doms[1].evicted, doms[0].evicted, "evicted")
        if not doms[0].n:
            continue
        frs = [frozenset(fr for info in d.infos
                         for fr in info.flavor_resource_keys())
               for d in doms]
        assert frs_key(frs[1]) == frs_key(frs[0])
        for within in ("Never", "LowerPriority", "LowerOrNewerEqualPriority"):
            for reclaim in ("Never", "LowerPriority", "Any"):
                for prio in (2, 5):
                    sels = [d.select(name, prio, 150.0, f, within,
                                     within == "LowerOrNewerEqualPriority",
                                     reclaim, reclaim != "Any")
                            for d, f in zip(doms, frs)]
                    assert_same(sels[1], sels[0], (within, reclaim, prio))
    # the problems of the preempt-mode heads, encoded and solved
    problems, batches = [], []
    for env, snap, ix, (_, pre, enc, _, _) in zip(envs, snaps, idx, mods):
        heads = preempt_mode_heads(env, snap)
        probs, req_by, frs_by, cq_by = [], {}, {}, {}
        for i, (w, req, frs) in enumerate(heads):
            req_by[i], frs_by[i], cq_by[i] = req, frs, w.cluster_queue
            probs.extend(pre.build_problems(i, w, req, frs, snap,
                                            env.scheduler.preemptor, ix))
        problems.append(probs)
        topo = enc.encode_topology(snap)
        batches.append((pre.encode_problems(probs, snap, topo, req_by, cq_by,
                                            frs_by), topo, snap, cq_by))
    assert [p.num_candidates for p in problems[1]] == \
        [p.num_candidates for p in problems[0]]
    assert problems[0]
    (jb, jtopo, jsnap, jcq), (tb, ttopo, tsnap, tcq) = batches
    for name, a, b in zip(("gq", "gf", "gr", "gc", "chain_local", "requests",
                           "frs_np", "cand_idx", "cand_ql", "cand_usage",
                           "cand_prio", "allow_borrowing", "threshold_active",
                           "threshold", "has_cohort"),
                          tpre.preempt_args(tb), jpre.preempt_args(jb)):
        assert_same(a, b, name)
    jstate = jenc.encode_state(jsnap, jtopo)
    tstate = tenc.encode_state(tsnap, ttopo)
    ref = jax_solve({k: getattr(jtopo, k) for k in jk.TOPO_FIELDS},
                    jstate.usage, jstate.cohort_usage, jpre.preempt_args(jb))
    got = port_solve({k: getattr(ttopo, k) for k in tk.TOPO_FIELDS},
                     tstate.usage, tstate.cohort_usage, tpre.preempt_args(tb))
    for name, a, b in zip(OUTPUTS, got, ref):
        assert_same(a, b, name)
    decoded = [pre.decode_targets(b, out[0], out[1], snap, cq)
               for pre, b, out, snap, cq in ((jpre, jb, ref, jsnap, jcq),
                                             (tpre, tb, got, tsnap, tcq))]
    flat = [{i: [(x.workload_info.key, x.reason) for x in ts]
             for i, ts in d.items()} for d in decoded]
    assert flat[1] == flat[0]


# --- the usage from before the cycle ---

def test_solve_preempt_reads_the_pre_cycle_usage():
    """A bound cycle admits `fit` (3 cpu) into cq, whose 10 cpu already
    hold two 3-cpu victims; the 7-cpu preemptor of the same CQ needs only
    the newer victim against the usage the cycle read (6 used), but both
    against the usage Phase B left (9 used). BatchSolver.solve_preempt
    after the cycle gives the former, as the JAX package's solve on the
    pre-cycle state does."""
    setup = with_existing(one_cq("10"), lambda: [
        wl("v1", "lq", 0, "3", reserve="cq", now=1.0),
        wl("v2", "lq", 0, "3", reserve="cq", now=2.0)])
    out = []
    for pkg in PKGS:
        cand, pre, enc, _, fr_cls = MODS[pkg]
        env = Env(pkg, "device", preempt="device")
        setup(env)
        env.submit(wl("fit", "lq", 1, "3"))
        info = env.wlpkg.Info(env.conv(wl("pre", "lq", 10, "7")))
        info.cluster_queue = "cq"
        fr = fr_cls("default", "cpu")
        req, frs = {fr: 7000}, {fr}
        snap = env.cache.snapshot()
        ix = cand.candidate_index(snap, env.scheduler.ordering, 1000.0)
        probs = pre.build_problems(0, info, req, frs, snap,
                                   env.scheduler.preemptor, ix)
        topo = enc.encode_topology(snap)
        batch = pre.encode_problems(probs, snap, topo, {0: req}, {0: "cq"},
                                    {0: frs})
        if pkg == "kueue_tpu":
            state = enc.encode_state(snap, topo)
            targets, feasible = jpre.solve_preemption_batch(
                jk.topo_to_device(topo), state.usage, state.cohort_usage,
                batch)
        else:
            solver = env.scheduler.solver
            plan = solver.prepare(snap, env.queues.heads_nonblocking())
            decisions, aux = solver.solve_prepared(plan, snap)
            assert aux is None and decisions[0][1]  # `fit` admitted
            targets, feasible, _ = solver.solve_preempt(batch)
            assert solver.last_phase_s["preempt"] > 0
            # the resident state Phase B left holds `fit`
            rs = solver.resident
            after = tk.solve_preempt(plan.topo_dev, rs.usage_dev,
                                     rs.cohort_dev,
                                     *(t(a) for a in tpre.preempt_args(batch)))
            assert not np.array_equal(after[0].numpy(), targets)
        out.append([(x.workload_info.obj.metadata.name, x.reason)
                    for x in pre.decode_targets(batch, targets, feasible,
                                                snap, {0: "cq"})[0]])
    assert out[1] == out[0] == [("v2", "InClusterQueue")]


@pytest.mark.parametrize("bound", (True, False))
def test_solve_prepared_with_preempt_batch(bound):
    """solve_prepared(preempt_batch=...) solves the batch in the cycle's
    own dispatch (the arena cycle when bound, solve_cycle_with_preempt
    when not), against the same pre-cycle usage as solve_preempt; with
    fair_batch=... (the same preemptor as a fair problem) it returns the
    fair aux too, equal to solve_preemptions after the dispatch."""
    setup = with_existing(one_cq("10"), lambda: [
        wl("v1", "lq", 0, "3", reserve="cq", now=1.0),
        wl("v2", "lq", 0, "3", reserve="cq", now=2.0)])
    env = Env("kueue_tpu_torch", "device", preempt="device")
    setup(env)
    env.submit(wl("fit", "lq", 1, "3"))
    fr = TorchFR("default", "cpu")
    info = env.wlpkg.Info(env.conv(wl("pre", "lq", 10, "7")))
    info.cluster_queue = "cq"
    snap = env.cache.snapshot()
    ix = tcand.candidate_index(snap, env.scheduler.ordering, 1000.0)
    probs = tpre.build_problems(0, info, {fr: 7000}, {fr}, snap,
                                env.scheduler.preemptor, ix)
    solver = env.scheduler.solver if bound else BatchSolver(device="cpu")
    plan = solver.prepare(snap, env.queues.heads_nonblocking())
    assert (plan.slots is not None) == bound
    batch = tpre.encode_problems(probs, snap, plan.topo, {0: {fr: 7000}},
                                 {0: "cq"}, {0: {fr}})
    decisions, aux = solver.solve_prepared(plan, snap, preempt_batch=batch)
    assert decisions[0][1]
    targets, feasible = aux["preempt"]
    again = solver.solve_preempt(batch)
    assert_same(targets, again[0])
    assert_same(feasible, again[1])
    assert_same(aux["preempt_stats"], again[2])
    assert targets[0].sum() == 1 and feasible[0]
    fair = tfp.encode_fair_problems(
        [tfp.FairProblem(0, probs[0].domain, probs[0].sel,
                         extra_frs=probs[0].domain.all_frs())],
        snap, plan.topo, {0: {fr: 7000}}, {0: "cq"}, {0: {fr}})
    flags = tfp.strategy_flags(env.scheduler.preemptor.fs_strategies)
    _, aux = solver.solve_prepared(plan, snap, preempt_batch=batch,
                                   fair_batch=fair, fs_flags=flags)
    assert set(aux) == {"preempt", "preempt_stats", "fair", "fair_stats"}
    again = solver.solve_preemptions(batch, fair, flags)
    for k in aux:
        for a, b in zip(aux[k] if k in ("preempt", "fair") else (aux[k],),
                        again[k] if k in ("preempt", "fair")
                        else (again[k],)):
            assert_same(a, b, k)
    fair_targets, fair_feasible, reasons = aux["fair"]
    assert fair_feasible[0] and fair_targets[0].sum() >= 1
    assert (reasons[0][fair_targets[0]] == 0).all()  # all in its own CQ


def test_estimated_sync_floor():
    """The work gate's sync floor: a trivial launch and sync timed once,
    then the minimum of it and the observed syncs, so a first launch
    that builds the kernels does not raise it."""
    solver = BatchSolver(device="cpu")
    probe = solver.estimated_sync_ms()
    assert probe > 0
    solver._observe_sync(1e6)
    assert solver.estimated_sync_ms() == probe
    solver._observe_sync(probe / 2)
    assert solver.estimated_sync_ms() == probe / 2
