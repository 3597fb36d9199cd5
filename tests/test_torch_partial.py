"""Batched partial admission: the port against the JAX package.

BatchSolver.batched_partial_admission (the heads' binary searches in
lockstep, Phase A a round; the port's plain versions on the CPU) is held
to the JAX solver's on the same snapshot and heads: reduced counts, no
counts, and CPU_FALLBACK for a probe the encoder cannot take. Then the
port's Scheduler against the JAX Scheduler on both routes ("device":
the batched search; "cpu": the sequential PodSetReducer), admissions,
messages, requeues and resume states (tests/test_torch_scheduler.py's
run_both): the two cases of tests/test_solver.py
TestBatchedPartialAdmission, Jobs of several pod sets (counts_for_index
interpolates each pod set's share), cohort borrowing, a bound run of
several cycles with completions in which the search must read the usage
the cycle started from (a probe of the mirror after the cycle's own
admissions would find a smaller count), and 40 random scenarios.
"""

import random

import pytest

import kueue_tpu.solver.kernel  # noqa: F401  enables jax x64 before any array
from kueue_tpu.api import kueue as japi
from kueue_tpu.solver.service import CPU_FALLBACK as JAX_FALLBACK
from kueue_tpu_torch.solver.service import CPU_FALLBACK
from tests.test_torch_scheduler import (  # noqa: F401  (fixture)
    PKGS,
    ROUTES,
    Env,
    _reset_features,
    run_both,
)
from tests.wrappers import ClusterQueueWrapper, WorkloadWrapper, flavor_quotas


def three_cqs(env, cpu="6", cohort=None):
    env.add_flavor("default")
    for i in range(3):
        w = ClusterQueueWrapper(f"cq{i}")
        if cohort:
            w = w.cohort(cohort)
        env.add_cq(w.resource_group(flavor_quotas("default", cpu=cpu)).obj(),
                   f"lq-cq{i}")


def two_flavor_cohort(env):
    """cq0..cq3 in one cohort; each offers flavor a (4 cpu, 8Gi) then b
    (2 cpu, 4Gi); cq3 may borrow nothing."""
    for f in ("a", "b"):
        env.add_flavor(f)
    for i in range(4):
        a = ("4", "0") if i == 3 else "4"
        env.add_cq(ClusterQueueWrapper(f"cq{i}").cohort("team")
                   .resource_group(flavor_quotas("a", cpu=a, memory="8Gi"),
                                   flavor_quotas("b", cpu="2",
                                                 memory="4Gi"))
                   .obj(), f"lq-cq{i}")


def probe_case(name):
    """(setup, workloads) of the solver-level cases."""
    if name == "reduce":
        def workloads():
            return [WorkloadWrapper(f"big{i}").queue(f"lq-cq{i}")
                    .creation(float(i))
                    .pod_set(count=10, min_count=2, cpu=1).obj()
                    for i in range(3)]
        return three_cqs, workloads
    if name == "mixed":
        def workloads():
            return [
                WorkloadWrapper("reduce").queue("lq-cq0").creation(0.0)
                .pod_set(count=9, min_count=3, cpu=1).obj(),
                WorkloadWrapper("never").queue("lq-cq1").creation(1.0)
                .pod_set(count=20, min_count=8, cpu=1).obj(),
                WorkloadWrapper("fits").queue("lq-cq2").creation(2.0)
                .pod_set(count=4, min_count=2, cpu=1).obj()]
        return three_cqs, workloads
    if name == "fallback":
        def workloads():
            # gpu is covered by no resource group: the probe cannot be
            # encoded, so the head goes back to the CPU reducer
            return [
                WorkloadWrapper("gpu").queue("lq-cq0").creation(0.0)
                .pod_set(count=9, min_count=3, cpu=1, example_com_gpu=1)
                .obj(),
                WorkloadWrapper("reduce").queue("lq-cq1").creation(1.0)
                .pod_set(count=9, min_count=3, cpu=1).obj()]
        return three_cqs, workloads
    if name == "multi_podset":
        def workloads():
            return [
                WorkloadWrapper("two").queue("lq-cq0").creation(0.0)
                .pod_set("leader", count=3, min_count=1, cpu="500m")
                .pod_set("workers", count=12, min_count=4, cpu=1).obj(),
                WorkloadWrapper("three").queue("lq-cq1").creation(1.0)
                .pod_set("a", count=2, cpu=1)
                .pod_set("b", count=7, min_count=2, cpu="750m")
                .pod_set("c", count=5, min_count=1, cpu="250m").obj()]
        return three_cqs, workloads
    if name == "borrowing":
        def workloads():
            return [WorkloadWrapper(f"w{i}").queue(f"lq-cq{i}")
                    .creation(float(i))
                    .pod_set(count=12 + 4 * i, min_count=2, cpu=1,
                             memory="1Gi").obj() for i in range(4)]
        return two_flavor_cohort, workloads
    raise ValueError(name)


def normalized(results: dict, fallback) -> dict:
    return {i: "fallback" if v is fallback else v
            for i, v in results.items()}


@pytest.mark.parametrize("name", ("reduce", "mixed", "fallback",
                                  "multi_podset", "borrowing"))
def test_batched_search_matches_jax(name):
    """The solvers alone: a cycle is prepared (and on the port
    dispatched, which is where the search reads its usage), then the
    search runs over every head, the fitting ones too (they find their
    full counts)."""
    setup, workloads = probe_case(name)
    got = {}
    for pkg in PKGS:
        env = Env(pkg, "device")
        setup(env)
        for w in workloads():
            env.submit(w)
        heads = env.queues.heads(timeout=0.01)
        snapshot = env.cache.snapshot()
        solver = env.scheduler.solver
        plan = solver.prepare(snapshot, heads)
        if pkg == "kueue_tpu_torch":
            solver.solve_prepared(plan, snapshot)
            syncs = solver.counters["syncs"]
            res = solver.batched_partial_admission(plan, snapshot, heads)
            assert solver.counters["syncs"] - syncs == \
                solver.last_partial_rounds > 0
            assert solver.last_phase_s["partial"] > 0
            res = normalized(res, CPU_FALLBACK)
        else:
            res = normalized(solver.batched_partial_admission(
                plan, snapshot, heads), JAX_FALLBACK)
        got[pkg] = {h.key: res[i] for i, h in enumerate(heads)}
    assert got["kueue_tpu_torch"] == got["kueue_tpu"]
    found = got["kueue_tpu"]
    if name == "reduce":
        assert all(v == [6] for v in found.values())
    elif name == "mixed":
        assert found == {"default/reduce": [6], "default/never": None,
                         "default/fits": [4]}
    elif name == "fallback":
        assert found["default/gpu"] == "fallback"
        assert found["default/reduce"] == [6]
    elif name == "multi_podset":
        # every pod set scales by its share of the reduction index
        assert all(len(v) == len(c) for v, c in
                   zip(found.values(), ([3, 12], [2, 7, 5])))
        assert found["default/two"] != [3, 12]


def reduced_counts_workloads():
    return [WorkloadWrapper(f"big{i}").queue(f"lq-cq{i}").creation(float(i))
            .pod_set(count=10, min_count=2, cpu=1).obj() for i in range(3)]


@pytest.mark.parametrize("route", ROUTES)
def test_reduced_counts_match_jax(route):
    """tests/test_solver.py TestBatchedPartialAdmission
    .test_reduced_counts_match_cpu: 10 pods x 1 cpu against a quota of
    6, every head reduced to 6."""
    got, env = run_both(three_cqs, reduced_counts_workloads, route)
    assert len(got["applied"]) == 3
    for key, (_, psas, _) in got["applied"].items():
        assert psas[0][3] == 6, key
    if route == "device":
        assert env.scheduler.solver.last_partial_rounds > 0


@pytest.mark.parametrize("route", ROUTES)
def test_infeasible_and_mixed_match_jax(route):
    """TestBatchedPartialAdmission.test_infeasible_and_mixed: one head
    reduces, one cannot fit even at its minimum (the batch path's
    generic message on the device route), one fits outright."""
    _, workloads = probe_case("mixed")
    got, _ = run_both(three_cqs, workloads, route)
    assert set(got["applied"]) == {"default/reduce", "default/fits"}
    assert got["applied"]["default/reduce"][1][0][3] == 6
    assert got["applied"]["default/fits"][1][0][3] == 4
    msgs = {k: m for k, _, _, m in got["requeues"]}
    if route == "device":
        assert msgs["default/never"] == ("couldn't assign flavors: "
                                         "insufficient quota (batched "
                                         "assignment)")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ("fallback", "multi_podset", "borrowing"))
def test_scheduler_cases_match_jax(name, route):
    """A probe the encoder cannot take (the head goes to the CPU
    reducer), Jobs of two and three pod sets, and cohort borrowing over
    two flavors, through two cycles."""
    setup, workloads = probe_case(name)
    got, _ = run_both(setup, workloads, route, cycles=2)
    assert got["applied"]


def resident_setup(env):
    """cq-a and cq-b in one cohort of 12 cpu."""
    env.add_flavor("default")
    for name in ("a", "b"):
        env.add_cq(ClusterQueueWrapper(f"cq-{name}").cohort("team")
                   .resource_group(flavor_quotas("default", cpu="6")).obj(),
                   f"lq-{name}")


def resident_workloads():
    """cq-a's fit heads of 4 cpu; cq-b's partial heads of up to 14 pods
    of 1 cpu, more than the cohort's 12."""
    out = [WorkloadWrapper(f"fit{j}").queue("lq-a").creation(float(j))
           .pod_set(count=1, cpu="4").obj() for j in range(4)]
    out += [WorkloadWrapper(f"part{j}").queue("lq-b")
            .creation(float(j) + 0.5)
            .pod_set(count=14, min_count=2, cpu=1).obj() for j in range(3)]
    return out


def finish_admitted(env, cycle):
    """The last cycle's admissions complete: their quota is released and
    the parked heads are queued again."""
    finished = env.__dict__.setdefault("finished", set())
    for key, wl in list(env.client.applied.items()):
        if key not in finished:
            finished.add(key)
            env.cache.delete_workload(wl)
    env.queues.queue_inadmissible_workloads(set(env.cq_names))


def test_resident_search_reads_the_pre_cycle_usage():
    """The bound solver's first cycle admits cq-a's 4-cpu head on the
    card; cq-b's 14-pod head does not fit, and its search must find 12
    pods (the cohort before the cycle), which no longer fit once the
    4 cpu are accounted, so it is skipped. A search of the resident
    mirror, which the decode has already moved on by those 4 cpu, would
    find 8 and admit them. Then cycles with completions between them."""
    got, port = run_both(resident_setup, resident_workloads, "device")
    assert set(got["applied"]) == {"default/fit0"}
    skipped = [m for k, _, _, m in got["requeues"] if k == "default/part0"]
    assert skipped == ["Workload no longer fits after processing another "
                       "workload"]
    solver = port.scheduler.solver
    assert solver.resident is not None and solver.last_partial_rounds
    got, _ = run_both(resident_setup, resident_workloads, "device",
                      cycles=5, between=finish_admitted)
    counts = {k: psas[0][3] for k, (_, psas, _) in got["applied"].items()}
    assert any(k.startswith("default/part") for k in counts)


def random_partial_scenario(seed: int):
    """1-3 cohorts of 2-4 CQs (some standalone), 1-2 flavors of cpu and
    memory, borrowing limits, some CQs with a LowerPriority policy (their
    partial heads go to the CPU reducer); 2-4 workloads per CQ of 1-3
    pod sets, most with a min_count, some over any quota."""
    rng = random.Random(seed)
    flavors = ["f0", "f1"][:rng.randint(1, 2)]
    num_cqs = rng.randint(3, 8)
    cqs = []
    for i in range(num_cqs):
        cohort = None if rng.random() < 0.2 else f"co{rng.randint(0, 2)}"
        quotas = []
        for f in flavors:
            cpu = str(rng.randint(2, 8))
            if rng.random() < 0.3:
                cpu = (cpu, str(rng.randint(0, 3)))
            quotas.append(flavor_quotas(f, cpu=cpu,
                                        memory=f"{rng.randint(4, 16)}Gi"))
        preempt = rng.random() < 0.25
        cqs.append((f"cq{i}", cohort, quotas, preempt))

    def setup(env):
        for f in flavors:
            env.add_flavor(f)
        for name, cohort, quotas, preempt in cqs:
            w = ClusterQueueWrapper(name)
            if cohort:
                w = w.cohort(cohort)
            if preempt:
                w = w.preemption(
                    within_cluster_queue=japi.PREEMPTION_LOWER_PRIORITY)
            env.add_cq(w.resource_group(*quotas).obj(), f"lq-{name}")

    specs = []
    n = 0
    for name, _, _, _ in cqs:
        for _ in range(rng.randint(2, 4)):
            pod_sets = []
            for p in range(rng.randint(1, 3)):
                count = rng.randint(1, 16)
                mn = rng.randint(1, count) if rng.random() < 0.8 else None
                pod_sets.append((f"ps{p}", count, mn,
                                 f"{rng.choice((250, 500, 1000, 1500))}m",
                                 f"{rng.choice((256, 512, 1024))}Mi"))
            specs.append((f"w{n}", f"lq-{name}", rng.randint(0, 2),
                          float(n), pod_sets))
            n += 1

    def workloads():
        out = []
        for wname, lq, prio, created, pod_sets in specs:
            w = WorkloadWrapper(wname).queue(lq).priority(prio) \
                .creation(created)
            for ps, count, mn, cpu, mem in pod_sets:
                w = w.pod_set(ps, count=count, min_count=mn, cpu=cpu,
                              memory=mem)
            out.append(w.obj())
        return out
    return setup, workloads


@pytest.mark.parametrize("seed", range(40))
def test_random_partial_admission(seed):
    """Three cycles with completions between them, on the device route
    (both routes on every fourth seed)."""
    setup, workloads = random_partial_scenario(seed)
    for route in ROUTES if seed % 4 == 0 else ("device",):
        run_both(setup, workloads, route, cycles=3, between=finish_admitted)
