"""The port's Scheduler against the JAX package's, cycle by cycle.

Each scenario is built twice from the same objects: with the JAX
package's api, cache, queue Manager and Scheduler, and, converted field
by field into the port's api, with the port's (`to_pkg`). Both run the
same cycles on the same route:

- "device": a BatchSolver (the port's on the CPU, its kernels' plain
  versions) and solver_min_heads=0, so every cycle takes the solve
  stage; both Schedulers' preemption work gates are set alike: pinned
  to the CPU Preemptor, or (device preemption) sending every
  preempt-mode head with candidates to the batched solve, K9 (the JAX
  package's on JAX-CPU, the port's plain version);
- "cpu": a solver with the default solver_min_heads, which these narrow
  cycles stay under, so the whole cycle runs on the CPU path.

After the cycles the applied admissions (flavors, counts, usage,
conditions), the evictions, the Pending patches, the events, every
requeue (status, reason, message), each pending workload's
last_assignment, the cache's usage per ClusterQueue and the Manager's
pending counts are equal. Scenarios: the fair-sharing cases of
tests/test_solver.py (share before priority, weight scaling, zero
weight last, ten seeded random cohorts), cases of tests/test_scheduler.py
(basic admission, cohort borrowing, a LowerPriority preemption), a
partial admission, and five cycles of the fair-sharing benchmark
configuration at 16 ClusterQueues in 4 cohorts with completions; with
device preemption on, the cases of tests/test_preempt_solver.py
TestDevicePreemption and tests/test_preempt_batched.py (a node shared at
two depths, fill-back), seeded random nested-cohort scenarios and the
preemption-heavy reclaim configuration at 2 roots x 2 children x 4 CQs x
6 victims, where both Schedulers must also report the same solve stats
(last_preempt_plan); with fair sharing and device preemption on (K11,
and K9 for the heads whose candidates are all in their own CQ), the
cases of tests/test_preempt_solver.py TestFairSharingThroughSolverPath
and TestFairPreemptionsOnDevice (every strategy order, the retry pass,
the borrowWithinCohort threshold, eight seeded random cohorts, a
max-share preemptor with no candidate of its own), the fair-sharing
preemption configuration at 16 CQs in 2 cohorts and a cycle with both
kinds of problem; each of these is also held against the port's own CPU
Preemptor (the same evictions, Preempted reasons and admissions).
"""

import dataclasses
import importlib
import random
from enum import Enum

import pytest

import kueue_tpu.solver.kernel  # noqa: F401  enables jax x64 before any array
from kueue_tpu import features as jax_features
from kueue_tpu.api import kueue as japi
from kueue_tpu_torch import features as torch_features
from tests.test_torch_queue import queue_state
from tests.wrappers import (
    ClusterQueueWrapper,
    WorkloadWrapper,
    flavor_quotas,
    make_flavor,
    make_local_queue,
)

CPU = "cpu"
PKGS = ("kueue_tpu", "kueue_tpu_torch")


@pytest.fixture(autouse=True)
def _reset_features():
    jax_features.reset()
    torch_features.reset()
    yield
    torch_features.reset()


def to_pkg(obj, pkg: str):
    """A copy of an api object (dataclasses, containers, enums) in
    package `pkg`'s classes of the same module and name."""
    if isinstance(obj, Enum) or (dataclasses.is_dataclass(obj)
                                 and not isinstance(obj, type)):
        mod = type(obj).__module__.split(".", 1)[1]
        cls = getattr(importlib.import_module(f"{pkg}.{mod}"),
                      type(obj).__name__)
        if isinstance(obj, Enum):
            return cls[obj.name]
        return cls(**{f.name: to_pkg(getattr(obj, f.name), pkg)
                      for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple, set)):
        return type(obj)(to_pkg(x, pkg) for x in obj)
    if isinstance(obj, dict):
        return {to_pkg(k, pkg): to_pkg(v, pkg) for k, v in obj.items()}
    return obj


class FakeClient:
    """tests/test_scheduler.py's FakeClient for either package; events
    keep their messages."""

    def __init__(self, wlpkg):
        self.wlpkg = wlpkg
        self.applied = {}
        self.evicted = {}
        self.pending_patches = []
        self.events = []
        self.namespaces = {"default": {}}

    def namespace_labels(self, namespace):
        return self.namespaces.get(namespace)

    def limit_ranges(self, namespace):
        return []

    def apply_admission(self, wl):
        target = self.evicted if self.wlpkg.is_evicted(wl) else self.applied
        target[self.wlpkg.key(wl)] = wl

    def patch_not_admitted(self, wl):
        self.pending_patches.append(wl)

    def event(self, wl, event_type, reason, message):
        self.events.append((self.wlpkg.key(wl), reason, message))


class Env:
    """A cache, a queue Manager and a Scheduler of one package, with a
    BatchSolver (or `solver`) on the given route."""

    def __init__(self, pkg: str, route: str, fair_sharing=False,
                 preempt="cpu", fs_strategies=None, solver=None):
        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")
        self.pkg = pkg
        self.wlpkg = mod("core.workload")
        self.clock = mod("api.meta").FakeClock(1000.0)
        self.cache = mod("cache").Cache()
        self.queues = mod("queue").Manager(clock=self.clock)
        self.client = FakeClient(self.wlpkg)
        if solver is None:
            solver_cls = mod("solver").BatchSolver
            solver = solver_cls(device="cpu") if pkg == "kueue_tpu_torch" \
                else solver_cls()
        self.scheduler = mod("scheduler.scheduler").Scheduler(
            self.queues, self.cache, self.client, clock=self.clock,
            fair_sharing_enabled=fair_sharing, solver=solver,
            fs_preemption_strategies=fs_strategies,
            solver_min_heads=0 if route == "device" else 64)
        set_preempt_gate(self.scheduler, pkg, preempt)
        self.requeues = []
        real = self.scheduler.requeue_and_update

        def requeue_and_update(e):
            real(e)
            self.requeues.append((e.info.key, e.status, e.requeue_reason.name,
                                  e.inadmissible_msg))
        self.scheduler.requeue_and_update = requeue_and_update
        self.cq_names = []

    def conv(self, obj):
        return obj if self.pkg == "kueue_tpu" else to_pkg(obj, self.pkg)

    def add_cohort(self, name, parent=""):
        from tests.wrappers import make_cohort
        self.cache.add_or_update_cohort(self.conv(make_cohort(name, parent)))

    def add_flavor(self, name, labels=None, taints=None):
        self.cache.add_or_update_resource_flavor(
            self.conv(make_flavor(name, labels, taints)))

    def add_cq(self, cq, lq_name=None):
        cq = self.conv(cq)
        self.cache.add_cluster_queue(cq)
        self.queues.add_cluster_queue(cq)
        self.queues.add_local_queue(self.conv(make_local_queue(
            lq_name or f"lq-{cq.metadata.name}", "default",
            cq.metadata.name)))
        self.cq_names.append(cq.metadata.name)

    def admit_existing(self, wl):
        self.cache.add_or_update_workload(self.conv(wl))

    def submit(self, wl):
        assert self.queues.add_or_update_workload(self.conv(wl))

    def cycle(self):
        return self.scheduler.schedule(timeout=0.01)


def set_preempt_gate(sched, pkg: str, preempt: str) -> None:
    """The preemption work gate, alike on both packages: "cpu" sends
    every preempt-mode entry to the CPU Preemptor, "device" every one
    with candidates to the batched solves (no sync floor to cover), with
    fair sharing on too. Neither Scheduler gets a watchdog: the JAX
    Scheduler's first compile runs under no deadline, and the port's
    dispatch runs inline as the JAX one does then (the deadlines are
    held alike in tests/test_torch_resilience.py)."""
    sched.solver_sync_floor_ms = 0.0
    if preempt == "cpu":
        sched.preempt_cand_us = 0.0
        sched.fair_cand_us = 0.0
    sched.watchdog = None


def conditions(wl):
    return tuple((c.type, c.status, c.reason, c.message, c.last_transition_time)
                 for c in wl.status.conditions)


def admission(wl):
    adm = wl.status.admission
    psas = tuple((p.name, tuple(sorted(p.flavors.items())),
                  tuple(sorted(p.resource_usage.items())), p.count)
                 for p in adm.pod_set_assignments)
    return adm.cluster_queue, psas, conditions(wl)


def usage_rows(usage: dict) -> tuple:
    return tuple(sorted((fr.flavor, fr.resource, v) for fr, v in usage.items()))


def observe(env, admissions_only=False) -> dict:
    wlpkg = env.wlpkg
    out = {"applied": {k: admission(wl) for k, wl in env.client.applied.items()},
           "usage": {cq: tuple(usage_rows(u) for u in
                               env.cache.usage_for_cluster_queue(cq))
                     for cq in env.cq_names}}
    if admissions_only:
        return out
    pending = {}
    for items in env.queues.local_queues.values():
        pending.update(items.items)
    out.update(
        evicted={k: conditions(wl) for k, wl in env.client.evicted.items()},
        patches=[(wlpkg.key(p), conditions(p))
                 for p in env.client.pending_patches],
        events=list(env.client.events),
        requeues=list(env.requeues),
        queues=queue_state(env),
        last_assignment={k: None if i.last_assignment is None
                         else dataclasses.asdict(i.last_assignment)
                         for k, i in sorted(pending.items())})
    return out


def run_both(setup, workloads, route, fair_sharing=False, cycles=1,
             between=None, admissions_only=False, preempt="cpu",
             envs_out=None, fs_strategies=None, solvers=None):
    """The scenario on both packages; returns the two observations after
    asserting they are equal, and the port's Env. envs_out, when given,
    receives both Envs (JAX first); solvers, when given, maps each
    package to a factory of its BatchSolver."""
    envs = [Env(pkg, route, fair_sharing, preempt, fs_strategies,
                None if solvers is None else solvers[pkg]())
            for pkg in PKGS]
    if envs_out is not None:
        envs_out.extend(envs)
    for env in envs:
        setup(env)
        for w in workloads():
            env.submit(w)
    for c in range(cycles):
        for env in envs:
            if between is not None and c > 0:
                between(env, c)
            env.cycle()
        port = envs[1].scheduler
        assert port.last_route == ("device" if route == "device"
                                   else "cpu-forced")
    ref, got = (observe(env, admissions_only) for env in envs)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == ref[k], k
    return got, envs[1]


ROUTES = ("device", "cpu")


# --- fair sharing (tests/test_solver.py TestSolverFairSharing) ---

def three_cq_setup(weights=None):
    def setup(env):
        env.add_flavor("default")
        for name, nominal in (("a", "2"), ("b", "8"), ("c", "4")):
            w = ClusterQueueWrapper(name).cohort("team")
            if weights and name in weights:
                w = w.fair_weight(weights[name])
            env.add_cq(w.resource_group(
                flavor_quotas("default", cpu=nominal)).obj(), f"lq-{name}")
    return setup


def contending_workloads():
    # wa borrows 6/14 (share 428), wb borrows 4/14 (share 285)
    return [
        WorkloadWrapper("wa").queue("lq-a").priority(10).creation(1)
        .pod_set(count=1, cpu="8").obj(),
        WorkloadWrapper("wb").queue("lq-b").priority(1).creation(2)
        .pod_set(count=1, cpu="12").obj(),
    ]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ("share_before_priority", "priority_wins",
                                  "weight_scales_share"))
def test_fair_sharing_order(case, route):
    fair = case != "priority_wins"
    weights = {"a": 4000} if case == "weight_scales_share" else None
    got, _ = run_both(three_cq_setup(weights), contending_workloads, route,
                      fair_sharing=fair)
    want = {"share_before_priority": {"default/wb"},
            "priority_wins": {"default/wa"},
            "weight_scales_share": {"default/wa"}}[case]
    assert set(got["applied"]) == want


@pytest.mark.parametrize("route", ROUTES)
def test_fair_sharing_zero_weight_sorts_last(route):
    def setup(env):
        env.add_flavor("default")
        for name, nominal in (("a", "2"), ("b", "8"), ("c", "4")):
            w = ClusterQueueWrapper(name).cohort("team")
            if name == "a":
                w = w.fair_weight(0)
            env.add_cq(w.resource_group(
                flavor_quotas("default", cpu=nominal)).obj(), f"lq-{name}")

    def workloads():
        return [
            WorkloadWrapper("wa").queue("lq-a").priority(10).creation(1)
            .pod_set(count=1, cpu="3").obj(),
            WorkloadWrapper("wb").queue("lq-b").priority(1).creation(2)
            .pod_set(count=1, cpu="12").obj(),
        ]

    got, _ = run_both(setup, workloads, route, fair_sharing=True)
    assert set(got["applied"]) == {"default/wb"}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", range(10))
def test_fair_sharing_random(seed, route):
    setup, workloads = fair_sharing_scenario(seed)
    run_both(setup, workloads, route, fair_sharing=True, cycles=2)


def fair_sharing_scenario(seed: int):
    """A cohort of 2-5 CQs of mixed fair weights and 3-10 contending
    workloads: (setup, workloads)."""
    rng = random.Random(7000 + seed)
    n_cqs = rng.randint(2, 5)
    specs = [(f"cq{i}", rng.choice([2, 5, 8]), rng.choice([500, 1000, 2000]))
             for i in range(n_cqs)]

    def setup(env):
        env.add_flavor("default")
        for name, nominal, weight in specs:
            env.add_cq(ClusterQueueWrapper(name).cohort("team")
                       .fair_weight(weight)
                       .resource_group(flavor_quotas(
                           "default", cpu=str(nominal))).obj(),
                       f"lq-{name}")

    wl_specs = [(f"w{i}", f"lq-cq{rng.randrange(n_cqs)}", rng.randint(0, 3),
                 float(i), str(rng.choice([1, 2, 4, 7, 12])))
                for i in range(rng.randint(3, 10))]

    def workloads():
        return [WorkloadWrapper(n).queue(q).priority(p).creation(ts)
                .pod_set(count=1, cpu=c).obj()
                for n, q, p, ts, c in wl_specs]
    return setup, workloads


# --- tests/test_scheduler.py cases ---

def simple_setup(nominal="10"):
    def setup(env):
        env.add_flavor("default")
        env.add_cq(ClusterQueueWrapper("cq").resource_group(
            flavor_quotas("default", cpu=nominal)).obj(), "lq")
    return setup


def one_workload(cpu, count=1, limit=None):
    def workloads():
        w = WorkloadWrapper("w").queue("lq").pod_set(count=count,
                                                     cpu=cpu).obj()
        if limit is not None:
            w.spec.pod_sets[0].template.spec.containers[0].limits[CPU] = limit
        return [w]
    return workloads


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ("fits", "no_quota", "namespace_mismatch",
                                  "limits_exceeded", "admission_checks",
                                  "non_borrowing_first"))
def test_basic_admission(case, route):
    workloads = one_workload("2", count=2)
    setup = simple_setup()
    if case == "no_quota":
        setup, workloads = simple_setup("1"), one_workload("2")
    elif case == "limits_exceeded":
        workloads = one_workload("1", limit=500)
    elif case == "namespace_mismatch":
        def setup(env):
            env.add_flavor("default")
            cq = (ClusterQueueWrapper("cq")
                  .resource_group(flavor_quotas("default", cpu="10")).obj())
            cq.spec.namespace_selector = type(cq.spec.namespace_selector)(
                match_labels={"team": "x"})
            env.add_cq(cq, "lq")
    elif case == "admission_checks":
        def setup(env):
            from kueue_tpu.api.meta import Condition, set_condition
            env.add_flavor("default")
            ac = japi.AdmissionCheck()
            ac.metadata.name = "prov"
            set_condition(ac.status.conditions, Condition(
                type=japi.ADMISSION_CHECK_ACTIVE, status="True"), 1.0)
            env.cache.add_or_update_admission_check(env.conv(ac))
            env.add_cq(ClusterQueueWrapper("cq").admission_checks("prov")
                       .resource_group(flavor_quotas("default", cpu="10"))
                       .obj(), "lq")
    elif case == "non_borrowing_first":
        def setup(env):
            env.add_flavor("default")
            for name in ("a", "b"):
                env.add_cq(ClusterQueueWrapper(name).cohort("team")
                           .resource_group(flavor_quotas("default", cpu="10"))
                           .obj(), f"lq-{name}")

        def workloads():
            return [WorkloadWrapper("big").queue("lq-a").priority(100)
                    .creation(1).pod_set(count=1, cpu="12").obj(),
                    WorkloadWrapper("small").queue("lq-b").priority(0)
                    .creation(2).pod_set(count=1, cpu="10").obj()]
    got, env = run_both(setup, workloads, route)
    want = {"fits": {"default/w"}, "no_quota": set(),
            "namespace_mismatch": set(), "limits_exceeded": set(),
            "admission_checks": {"default/w"},
            "non_borrowing_first": {"default/small"}}[case]
    assert set(got["applied"]) == want
    if case == "admission_checks":
        assert not env.wlpkg.is_admitted(env.client.applied["default/w"])


@pytest.mark.parametrize("route", ROUTES)
def test_lower_priority_preemption(route):
    """The victim is evicted by the CPU Preemptor on both routes; once
    its quota is released the preemptor is admitted."""
    def setup(env):
        env.add_flavor("default")
        env.add_cq(ClusterQueueWrapper("cq")
                   .preemption(within_cluster_queue=japi.PREEMPTION_LOWER_PRIORITY)
                   .resource_group(flavor_quotas("default", cpu="10")).obj(),
                   "lq")
        env.admit_existing(victim())

    def victim():
        return (WorkloadWrapper("victim").queue("lq").priority(0)
                .pod_set(count=1, cpu="8").reserve("cq", now=100.0).obj())

    def workloads():
        return [WorkloadWrapper("pre").queue("lq").priority(100)
                .pod_set(count=1, cpu="8").obj(),
                WorkloadWrapper("small").queue("lq").priority(50)
                .pod_set(count=1, cpu="1").obj()]

    def release(env, cycle):
        env.cache.delete_workload(env.conv(victim()))
        env.queues.queue_inadmissible_workloads({"cq"})

    got, _ = run_both(setup, workloads, route, cycles=3, between=release)
    assert set(got["evicted"]) == {"default/victim"}
    assert "default/pre" in got["applied"]


@pytest.mark.parametrize("route", ROUTES)
def test_partial_admission(route):
    """On the device route both Schedulers search the counts with their
    batched partial admission; on the CPU route with the sequential
    reducer. Admissions and messages are compared."""
    def workloads():
        return [WorkloadWrapper("w").queue("lq")
                .pod_set(count=10, min_count=2, cpu="1").obj(),
                WorkloadWrapper("x").queue("lq").priority(-1)
                .pod_set(count=3, min_count=1, cpu="4").obj()]

    got, _ = run_both(simple_setup("6"), workloads, route, cycles=2)
    psa = got["applied"]["default/w"][1][0]
    assert psa[3] == 6


# --- the fair-sharing benchmark configuration, five cycles ---

def bench_env(pkg: str, route: str, num_cqs: int, num_cohorts: int,
              weights=None):
    """bench.py build_env + bench_fair_sharing at a small size: one
    flavor, cpu and memory at 2 units per CQ, 4-unit workloads (every
    admission borrows), six waves staged; with `weights`, cq{i} weighs
    weights[i % len(weights)] (the bench's CQs all weigh 1000, so their
    shares are equal). The port's side is built by its sim
    (sim/northstar.py)."""
    if pkg == "kueue_tpu_torch":
        from kueue_tpu_torch.sim import northstar as ns
        from kueue_tpu_torch.solver import BatchSolver
        sched, cache, queues, client = ns.build_scheduler(
            num_cqs, num_cohorts, ["f0"], 2,
            solver=BatchSolver(device="cpu"), fair_sharing=True,
            fair_weights=weights)
        if route == "cpu":
            sched.solver_min_heads = num_cqs + 1
        sched.watchdog = None  # as the JAX side's below
        ns.stage_waves(queues, 6, num_cqs, 4)
        return sched, cache, queues, client, ns.finish_applied
    from kueue_tpu.api.meta import FakeClock
    from kueue_tpu.cache import Cache
    from kueue_tpu.queue import Manager
    from kueue_tpu.scheduler.scheduler import Scheduler
    from kueue_tpu.solver import BatchSolver
    from kueue_tpu_torch.sim import northstar as ns
    clock = FakeClock(1000.0)
    cache, queues = Cache(), Manager(clock=clock)
    client = ns.SimClient()
    client.apply_admission = _jax_apply(client)
    sched = Scheduler(queues, cache, client, clock=clock,
                      solver=BatchSolver(),
                      solver_min_heads=0 if route == "device" else num_cqs + 1,
                      fair_sharing_enabled=True)
    sched.watchdog = None
    cache.add_or_update_resource_flavor(to_pkg(ns.make_flavor("f0"),
                                               "kueue_tpu"))
    for i in range(num_cqs):
        cq = to_pkg(ns.make_cq(f"cq{i}", f"cohort-{i % num_cohorts}", ["f0"],
                               2, fair_weight=weights[i % len(weights)]
                               if weights else None), "kueue_tpu")
        cache.add_cluster_queue(cq)
        queues.add_cluster_queue(cq)
        queues.add_local_queue(to_pkg(ns.make_local_queue(f"lq{i}", f"cq{i}"),
                                      "kueue_tpu"))
    n = 0
    for wave in range(6):
        for i in range(num_cqs):
            assert queues.add_or_update_workload(to_pkg(ns.make_workload(
                f"w{wave}-{i}", f"lq{i}", cpu_units=4, priority=n % 5,
                creation=float(n)), "kueue_tpu"))
            n += 1

    def finish(cache, queues, client):
        done = client.drain_applied()
        for wl in done:
            cache.delete_workload(wl)
            queues.queue_associated_inadmissible_workloads_after(wl)
        return len(done)
    return sched, cache, queues, client, finish


def _jax_apply(client):
    from kueue_tpu.core import workload as jwlpkg

    def apply_admission(wl):
        if jwlpkg.is_evicted(wl):
            client.evicted += 1
        else:
            client.admitted += 1
            client.new_applied.append(wl)
    return apply_admission


FAIR_WEIGHTS = (500, 1000, 3000, 0, 2000)


def admitted_names(env, cycles: int) -> list:
    sched, cache, queues, client, finish = env
    names = []
    for _ in range(cycles):
        finish(cache, queues, client)
        sched.schedule(timeout=0)
        names.append(sorted(wl.metadata.name for wl in client.new_applied))
    return names


@pytest.mark.parametrize("weights", (None, FAIR_WEIGHTS))
@pytest.mark.parametrize("route", ROUTES)
def test_fair_bench_configuration(route, weights):
    num_cqs, num_cohorts = 16, 4
    envs = [bench_env(pkg, route, num_cqs, num_cohorts, weights)
            for pkg in PKGS]
    admitted = []
    for cycle in range(5):
        rows = []
        for sched, cache, queues, client, finish in envs:
            finish(cache, queues, client)
            sched.schedule(timeout=0)
            keys = sorted(k for k in (wl.metadata.namespace + "/"
                                      + wl.metadata.name
                                      for wl in client.new_applied))
            usage = [usage_rows(cache.usage_for_cluster_queue(f"cq{i}")[0])
                     for i in range(num_cqs)]
            rows.append((client.admitted, keys, usage, queues.pending_total(),
                         [queues.pending(f"cq{i}") for i in range(num_cqs)]))
        assert rows[1] == rows[0], cycle
        admitted.append(rows[1][0])
        assert envs[1][0].last_route == ("device" if route == "device"
                                         else "cpu-forced")
    # each cycle fills every cohort (4 CQs x 2 units, 4-unit workloads)
    assert admitted == [8, 16, 24, 32, 40]


def test_fair_weights_change_the_admissions():
    """With the bench's equal weights every head's share is the same and
    the order falls to priority; with mixed weights the share orders the
    cohort, so the same cycles admit other workloads. (What makes the
    weighted cases above, and the card's, sensitive to the shares.)"""
    same, mixed = (admitted_names(bench_env("kueue_tpu_torch", "device",
                                            16, 4, w), 3)
                   for w in (None, FAIR_WEIGHTS))
    assert [len(c) for c in same] == [len(c) for c in mixed] == [8, 8, 8]
    assert same != mixed


# --- device preemption: K9 on both sides (tests/test_preempt_solver.py) ---

def preempt_run(setup, workloads, cycles=1, between=None):
    """run_both on the device route with device preemption on; both
    Schedulers must have taken the device route for their preemptions
    and report the same solve stats. Returns the observation."""
    envs = []
    got, _ = run_both(setup, workloads, "device", cycles=cycles,
                      between=between, preempt="device", envs_out=envs)
    jax_sched, port_sched = (e.scheduler for e in envs)
    assert port_sched.last_preempt_gate == "device"
    assert port_sched.last_preempt_plan
    assert port_sched.last_preempt_plan == jax_sched.last_preempt_plan
    assert jax_sched.preemption_fallbacks == 0
    return got


def preempted_reasons(got) -> dict:
    return {k: [c[2] for c in conds if c[0] == japi.WORKLOAD_PREEMPTED]
            for k, conds in got["evicted"].items()}


def one_cq(nominal, within=japi.PREEMPTION_LOWER_PRIORITY):
    def setup(env):
        env.add_flavor("default")
        env.add_cq(ClusterQueueWrapper("cq")
                   .preemption(within_cluster_queue=within)
                   .resource_group(flavor_quotas("default", cpu=nominal))
                   .obj(), "lq")
    return setup


def with_existing(setup, existing):
    def full(env):
        setup(env)
        for w in existing():
            env.admit_existing(w)
    return full


def lenders_and_borrower(nominal_a="6", reclaim_a=japi.PREEMPTION_ANY,
                         within_a=japi.PREEMPTION_NEVER, bwc=None):
    def setup(env):
        env.add_flavor("default")
        env.add_cq(ClusterQueueWrapper("a").cohort("team")
                   .preemption(within_cluster_queue=within_a,
                               reclaim_within_cohort=reclaim_a,
                               borrow_within_cohort=bwc)
                   .resource_group(flavor_quotas("default", cpu=nominal_a))
                   .obj(), "lq-a")
        env.add_cq(ClusterQueueWrapper("b").cohort("team")
                   .resource_group(flavor_quotas(
                       "default", cpu="8" if bwc else "6")).obj(), "lq-b")
    return setup


def wl(name, queue, prio, cpu, reserve=None, now=0.0, creation=None):
    w = WorkloadWrapper(name).queue(queue).priority(prio)
    if creation is not None:
        w = w.creation(creation)
    w = w.pod_set(count=1, cpu=cpu)
    if reserve is not None:
        w = w.reserve(reserve, now=now)
    return w.obj()


PREEMPT_CASES = {
    # name: (setup, existing, workloads, evicted)
    "within_cq_priority": (
        one_cq("10"), lambda: [wl("low", "lq", 1, "8", reserve="cq")],
        lambda: [wl("high", "lq", 10, "8")], {"default/low"}),
    "minimal_set": (
        one_cq("9"),
        lambda: [wl(f"low{i}", "lq", i, "3", reserve="cq", now=float(i))
                 for i in range(3)],
        lambda: [wl("high", "lq", 10, "4")], None),
    "fill_back": (
        one_cq("10"),
        lambda: [wl("small", "lq", 1, "2", reserve="cq", now=1.0),
                 wl("big", "lq", 2, "8", reserve="cq", now=2.0)],
        lambda: [wl("high", "lq", 10, "8")], {"default/big"}),
    "fill_back_auction": (
        one_cq("14"),
        lambda: [wl(f"small{i}", "lq", i, "2", reserve="cq", now=float(i))
                 for i in range(3)]
        + [wl("big", "lq", 5, "8", reserve="cq", now=9.0)],
        lambda: [wl("high", "lq", 10, "8")], None),
    "reclaim_within_cohort": (
        lenders_and_borrower(),
        lambda: [wl("borrower", "lq-b", 5, "10", reserve="b")],
        lambda: [wl("claimant", "lq-a", 1, "6")], {"default/borrower"}),
    "reclaim_skips_non_borrowing_cq": (
        lenders_and_borrower(within_a=japi.PREEMPTION_LOWER_PRIORITY),
        lambda: [wl("in-quota", "lq-b", 0, "5", reserve="b", now=1.0),
                 wl("own-low", "lq-a", 0, "6", reserve="a", now=2.0)],
        lambda: [wl("claimant", "lq-a", 9, "6")], {"default/own-low"}),
    "borrow_within_cohort_threshold": (
        lenders_and_borrower(nominal_a="4", bwc=japi.BorrowWithinCohort(
            policy=japi.BORROW_WITHIN_COHORT_LOWER_PRIORITY,
            max_priority_threshold=5)),
        lambda: [wl("victim", "lq-b", 2, "10", reserve="b")],
        lambda: [wl("preemptor", "lq-a", 10, "6")], {"default/victim"}),
}


@pytest.mark.parametrize("case", sorted(PREEMPT_CASES))
def test_device_preemption(case):
    """TestDevicePreemption's and TestFillbackAuctionStats' scenarios:
    the port's Scheduler with K9 (plain) against the JAX Scheduler with
    its device preemption on JAX-CPU."""
    setup, existing, workloads, evicted = PREEMPT_CASES[case]
    got = preempt_run(with_existing(setup, existing), workloads)
    assert got["evicted"]
    if evicted is not None:
        assert set(got["evicted"]) == evicted
    if case == "minimal_set":
        assert len(got["evicted"]) == 2


def nested_setup(env):
    env.add_flavor("default")
    env.add_cohort("root")
    env.add_cohort("left", "root")
    env.add_cohort("right", "root")
    env.add_cq(ClusterQueueWrapper("a").cohort("left")
               .preemption(reclaim_within_cohort=japi.PREEMPTION_ANY)
               .resource_group(flavor_quotas("default", cpu="10")).obj(),
               "lq-a")
    env.add_cq(ClusterQueueWrapper("b").cohort("right")
               .resource_group(flavor_quotas("default", cpu="10")).obj(),
               "lq-b")
    env.admit_existing(wl("borrower", "lq-b", 0, "14", reserve="b"))


def shared_node_setup(env):
    """tests/test_preempt_batched.py TestMultiDepthSharedNode: cq `top`
    hangs off the root, `deep` off a child, so the root sits at chain
    position 0 for one and 1 for the other."""
    env.add_flavor("default")
    env.add_cohort("root")
    env.add_cohort("child", "root")
    env.add_cq(ClusterQueueWrapper("top").cohort("root")
               .preemption(reclaim_within_cohort=japi.PREEMPTION_ANY)
               .resource_group(flavor_quotas("default", cpu="10")).obj(),
               "lq-top")
    env.add_cq(ClusterQueueWrapper("deep").cohort("child")
               .preemption(reclaim_within_cohort=japi.PREEMPTION_ANY)
               .resource_group(flavor_quotas("default", cpu="6")).obj(),
               "lq-deep")
    for i in range(4):
        env.admit_existing(wl(f"v{i}", "lq-deep", 0, "3", reserve="deep",
                              now=float(i)))


@pytest.mark.parametrize("case", ("nested_tree_reclaim",
                                  "shared_node_two_depths"))
def test_device_preemption_nested(case):
    if case == "nested_tree_reclaim":
        got = preempt_run(nested_setup,
                          lambda: [wl("claimant", "lq-a", 10, "10")])
        assert set(got["evicted"]) == {"default/borrower"}
    else:
        got = preempt_run(shared_node_setup,
                          lambda: [wl("claimant", "lq-top", 10, "10")])
        assert got["evicted"]
    assert all(r == [japi.IN_COHORT_RECLAMATION_REASON]
               for r in preempted_reasons(got).values())


def test_device_preemption_then_admission():
    """The victim's eviction completes between cycles; the preemptor is
    then admitted."""
    def release(env, cycle):
        if cycle == 1:
            env.cache.delete_workload(env.conv(
                wl("low", "lq", 1, "8", reserve="cq")))
            env.queues.queue_inadmissible_workloads({"cq"})

    envs = []
    got, _ = run_both(
        with_existing(one_cq("8"),
                      lambda: [wl("low", "lq", 1, "8", reserve="cq")]),
        lambda: [wl("high", "lq", 10, "8")], "device", cycles=2,
        between=release, preempt="device", envs_out=envs)
    assert set(got["evicted"]) == {"default/low"}
    assert "default/high" in got["applied"]
    for env in envs:
        assert env.scheduler.last_preempt_plan["minimal"]["problems"] == 1


def random_preempt_scenario(seed: int):
    """tests/test_preempt_batched.py's randomized scenarios: nested
    cohorts with CQs attached at different depths (or a flat one), cpu
    and memory, borrowWithinCohort thresholds, victims of varied sizes.
    Returns (setup, workloads)."""
    rng = random.Random(7700 + seed)
    policies = [japi.PREEMPTION_NEVER, japi.PREEMPTION_LOWER_PRIORITY,
                japi.PREEMPTION_LOWER_OR_NEWER_EQUAL_PRIORITY]
    reclaims = [japi.PREEMPTION_ANY, japi.PREEMPTION_LOWER_PRIORITY,
                japi.PREEMPTION_NEVER]
    n_cqs = rng.randint(3, 6)
    deep = rng.random() < 0.6
    cq_specs = []
    for i in range(n_cqs):
        cohort = (rng.choice(["root", "left", "right"]) if deep
                  else rng.choice(["root", ""]))
        bwc = None
        if cohort and rng.random() < 0.35:
            bwc = japi.BorrowWithinCohort(
                policy=japi.BORROW_WITHIN_COHORT_LOWER_PRIORITY,
                max_priority_threshold=rng.choice([None, 2, 5]))
        cq_specs.append((f"cq{i}", cohort, rng.choice(["4", "8", "12"]),
                         rng.choice(policies), rng.choice(reclaims), bwc))
    existing = [(f"old{i}", f"cq{rng.randrange(n_cqs)}", rng.randint(0, 6),
                 rng.choice(["1", "1", "2", "2", "3", "8", "10"]), float(i))
                for i in range(rng.randint(2, 9))]
    pending = [(f"new{i}", f"lq-cq{rng.randrange(n_cqs)}",
                rng.randint(2, 10), rng.choice(["4", "7", "10"]),
                float(100 + i)) for i in range(rng.randint(1, 4))]

    def setup(env):
        env.add_flavor("default")
        if deep:
            env.add_cohort("root")
            env.add_cohort("left", "root")
            env.add_cohort("right", "root")
        for name, cohort, nominal, wcq, rwc, bwc in cq_specs:
            w = ClusterQueueWrapper(name)
            if cohort:
                w = w.cohort(cohort)
            env.add_cq(w.preemption(within_cluster_queue=wcq,
                                    reclaim_within_cohort=rwc,
                                    borrow_within_cohort=bwc)
                       .resource_group(flavor_quotas(
                           "default", cpu=nominal,
                           memory=f"{int(nominal) * 2}Gi")).obj(),
                       f"lq-{name}")
        for n, cq, p, c, ts in existing:
            env.admit_existing(WorkloadWrapper(n).queue(f"lq-{cq}")
                               .priority(p).pod_set(count=1, cpu=c,
                                                    memory=f"{c}Gi")
                               .reserve(cq, now=ts).obj())

    def workloads():
        return [WorkloadWrapper(n).queue(q).priority(p).creation(ts)
                .pod_set(count=1, cpu=c, memory=f"{c}Gi").obj()
                for n, q, p, c, ts in pending]
    return setup, workloads


# seeds whose scenario has preempt-mode heads with candidates
PREEMPT_SEEDS = (4, 5, 10, 16, 26, 30, 33, 35)


@pytest.mark.parametrize("seed", PREEMPT_SEEDS)
def test_device_preemption_random(seed):
    """random_preempt_scenario, two cycles."""
    setup, workloads = random_preempt_scenario(seed)
    envs = []
    run_both(setup, workloads, "device", cycles=2, preempt="device",
             envs_out=envs)
    jax_sched, port_sched = (e.scheduler for e in envs)
    assert port_sched.last_preempt_plan
    assert port_sched.last_preempt_plan == jax_sched.last_preempt_plan
    assert jax_sched.preemption_fallbacks == 0


def reclaim_env(pkg: str, route: str):
    """The reclaim configuration (sim/northstar.build_preempt_reclaim) at
    2 roots x 2 children x 4 CQs x 6 victims, with device preemption on;
    the JAX side is built from the same objects converted."""
    from kueue_tpu_torch.sim import northstar as ns
    envs = Env(pkg, route, preempt="device")
    num_children, num_cqs = 4, 16
    envs.add_flavor("f0")
    for c in range(num_children):
        envs.add_cohort(f"cohort-{c}", f"root-{c // 2}")
    for i in range(num_cqs):
        cq = envs.conv(ns.make_cq(f"cq{i}", f"cohort-{i % num_children}",
                                  ["f0"], 8,
                                  preemption=ns.reclaim_preemption()))
        envs.cache.add_cluster_queue(cq)
        envs.queues.add_cluster_queue(cq)
        envs.queues.add_local_queue(envs.conv(ns.make_local_queue(
            f"lq{i}", f"cq{i}")))
        envs.cq_names.append(f"cq{i}")
    for i in range(num_cqs):
        if i >= num_children:
            for v in range(6):
                envs.admit_existing(ns.victim_workload(
                    f"victim{i}-{v}", f"lq{i}", f"cq{i}", 1500, 0, float(v)))
        envs.submit(ns.make_workload(f"preemptor{i}", f"lq{i}", cpu_units=8,
                                     priority=10, creation=1000.0))
    return envs


@pytest.mark.parametrize("route", ROUTES)
def test_reclaim_configuration(route):
    """Three cycles: the first admits one lender's preemptor per root
    (the roots have 10 units free), then the other lender of each root
    reclaims from its root's borrowers (their most recently admitted
    victims) and every borrower's own-CQ targets overlap those, so the
    borrowers are skipped. Evictions, reasons, admissions and solve stats
    equal on both Schedulers."""
    envs = [reclaim_env(pkg, route) for pkg in PKGS]
    for cycle in range(3):
        for env in envs:
            env.cycle()
        assert envs[1].scheduler.last_route == (
            "device" if route == "device" else "cpu-forced")
    ref, got = (observe(env) for env in envs)
    for k in ref:
        assert got[k] == ref[k], k
    assert len(got["applied"]) == 2
    assert got["evicted"]
    reasons = {r for rs in preempted_reasons(got).values() for r in rs}
    assert reasons == {japi.IN_COHORT_RECLAMATION_REASON}
    assert any(r[3] == "Workload has overlapping preemption targets with "
               "another workload" for r in envs[1].requeues)
    if route == "device":
        plans = [env.scheduler.last_preempt_plan for env in envs]
        assert plans[1] and plans[1] == plans[0]
        assert plans[1]["minimal"]["problems"] == 14 + 2


# --- fair-sharing preemption: K11 (and K9) on both sides
# (tests/test_preempt_solver.py TestFairSharingThroughSolverPath and
# TestFairPreemptionsOnDevice) ---

def fair_cohort(num_cqs=4, quota="4", bwc=None, names=None):
    """cq0.. (or `names`) in cohort "all", LowerPriority within the CQ,
    reclaimWithinCohort Any, borrowWithinCohort policy `bwc`."""
    def setup(env):
        env.add_flavor("default")
        for name in names or [f"cq{i}" for i in range(num_cqs)]:
            env.add_cq(fair_cohort_cq(name, quota, bwc), f"lq-{name}")
    return setup


def cpu_workloads(specs, reserve=False):
    """(name, cq, priority, creation, cpu) -> workloads queued to lq-<cq>,
    holding quota in <cq> when `reserve`."""
    out = []
    for name, cq, prio, ts, cpu in specs:
        w = (WorkloadWrapper(name).queue(f"lq-{cq}").priority(prio)
             .creation(ts).pod_set(count=1, cpu=cpu))
        if reserve:
            w = w.reserve(cq)
        out.append(w.obj())
    return out


def port_cpu_preemptor(setup, workloads, cycles, strategies=None) -> dict:
    """The scenario on the port alone, device route with the work gate
    pinned to the CPU Preemptor."""
    env = Env("kueue_tpu_torch", "device", True, "cpu", strategies)
    setup(env)
    for w in workloads():
        env.submit(w)
    for _ in range(cycles):
        env.cycle()
    assert env.scheduler.last_preempt_gate in ("", "cpu")
    return observe(env)


def fair_preempt_run(setup, workloads, cycles=1, strategies=None,
                     require_device=True):
    """run_both with fair sharing and device preemption on: both
    Schedulers report the same solve stats, the JAX one with no CPU
    fallback; then the port's device route against its own CPU
    Preemptor: the same evictions (with their Preempted reasons) and
    admissions. Returns (observation, the port's Scheduler)."""
    envs = []
    got, _ = run_both(setup, workloads, "device", fair_sharing=True,
                      cycles=cycles, preempt="device", envs_out=envs,
                      fs_strategies=strategies)
    jax_sched, port_sched = (e.scheduler for e in envs)
    assert jax_sched.preemption_fallbacks == 0
    assert port_sched.last_preempt_plan == jax_sched.last_preempt_plan
    if require_device:
        assert port_sched.last_preempt_gate == "device"
        assert port_sched.last_preempt_plan
    cpu = port_cpu_preemptor(setup, workloads, cycles, strategies)
    assert cpu["evicted"] == got["evicted"]
    assert cpu["applied"] == got["applied"]
    return got, port_sched


def test_fair_preemption_differential():
    """c is furthest under nominal and b borrows the most: fair sharing
    reclaims from b (preemption_test.go:1532-1546)."""
    setup = with_existing(fair_cohort(names=("a", "b", "c"), quota="3"),
                          lambda: cpu_workloads(
                              [(f"a{i}", "a", 0, float(i), "1")
                               for i in range(3)]
                              + [(f"b{i}", "b", 0, float(i), "1")
                                 for i in range(5)]
                              + [("c0", "c", 0, 0.0, "1")], reserve=True))
    got, sched = fair_preempt_run(setup, lambda: cpu_workloads(
        [("c_incoming", "c", 0, 100.0, "1")]))
    assert got["evicted"]
    assert all(r == [japi.IN_COHORT_FAIR_SHARING_REASON]
               for r in preempted_reasons(got).values())
    assert set(sched.last_preempt_plan) == {"fair"}


def uneven_borrowers():
    counts = {0: 2, 1: 7, 2: 5, 3: 1}  # cq1 borrows most
    return cpu_workloads([(f"w{q}-{i}", f"cq{q}", 0, float(i), "1")
                          for q, n in counts.items() for i in range(n)],
                         reserve=True)


FAIR_STRATEGIES = (None, ["LessThanOrEqualToFinalShare"],
                   ["LessThanInitialShare"],
                   ["LessThanInitialShare", "LessThanOrEqualToFinalShare"])


@pytest.mark.parametrize("strategies", FAIR_STRATEGIES,
                         ids=("default", "s2a", "s2b", "reversed"))
def test_fair_strategy_orders(strategies):
    """Uneven borrowing in the cohort; the incoming workload's CQ is
    under nominal, so fair sharing reclaims from the heaviest borrower
    first, under every strategy order."""
    got, _ = fair_preempt_run(
        with_existing(fair_cohort(), uneven_borrowers),
        lambda: cpu_workloads([("inc", "cq3", 5, 100.0, "2")]),
        strategies=strategies)
    assert got["evicted"]


def test_fair_retry_pass():
    """Every CQ a little over nominal and a large ask from cq0: S2-a
    refuses every candidate of the other CQs and only the S2-b retry
    pass finds a target set (the fill-back then walks it), where S2-a
    alone finds none. (The cohort is over its capacity, so the entry is
    then skipped as no longer fitting, on every route.)"""
    setup = with_existing(fair_cohort(quota="4"), lambda: cpu_workloads(
        [(f"w{q}-{i}", f"cq{q}", 0, float(i), "1")
         for q in range(4) for i in range(5)], reserve=True))

    def workloads():
        return cpu_workloads([("big", "cq0", 50, 100.0, "4")])
    _, sched = fair_preempt_run(setup, workloads)
    assert sched.last_preempt_plan["fair"]["fillback_rounds_max"] > 0
    _, alone = fair_preempt_run(setup, workloads,
                                strategies=["LessThanOrEqualToFinalShare"])
    assert alone.last_preempt_plan["fair"]["fillback_rounds_max"] == 0


def test_fair_borrow_within_cohort_threshold():
    """Victims below the borrowWithinCohort threshold are preemptable
    whatever the strategy says (InCohortReclaimWhileBorrowing)."""
    existing = lambda: cpu_workloads(  # noqa: E731
        [("w0-0", "cq0", 0, 0.0, "1")]
        + [(f"w1-{i}", "cq1", -5, float(i), "1") for i in range(6)],
        reserve=True)
    got, _ = fair_preempt_run(
        with_existing(fair_cohort(num_cqs=2, quota="4",
                                  bwc=japi.BORROW_WITHIN_COHORT_LOWER_PRIORITY),
                      existing),
        lambda: cpu_workloads([("inc", "cq0", 10, 100.0, "3")]))
    assert got["evicted"]


def random_fair_scenario(seed: int):
    """TestFairPreemptionsOnDevice.test_random_fair_differential's
    scenario of seed `seed`: (setup, workloads, strategies)."""
    rng = random.Random(1000 + seed)
    n_cqs = rng.randint(2, 5)
    quota = rng.choice(["2", "3", "4"])
    strategies = rng.choice([None, ["LessThanOrEqualToFinalShare"],
                             ["LessThanInitialShare"]])
    victims = []
    for qi in range(n_cqs):
        for i in range(rng.randint(0, 6)):
            victims.append((f"w{qi}-{i}", f"cq{qi}", rng.randint(-2, 4),
                            float(i), str(rng.choice([1, 1, 2]))))
    incoming = []
    for j in range(rng.randint(1, 3)):
        incoming.append((f"inc{j}", f"cq{rng.randrange(n_cqs)}",
                         rng.randint(3, 8), 100.0 + j,
                         str(rng.choice([1, 2, 3]))))
    setup = with_existing(fair_cohort(num_cqs=n_cqs, quota=quota),
                          lambda: cpu_workloads(victims, reserve=True))
    return setup, lambda: cpu_workloads(incoming), strategies


@pytest.mark.parametrize("seed", range(8))
def test_fair_preemption_random(seed):
    """random_fair_scenario, two cycles."""
    setup, workloads, strategies = random_fair_scenario(seed)
    fair_preempt_run(setup, workloads, cycles=2, strategies=strategies,
                     require_device=False)


@pytest.mark.parametrize("case", ("as_in_the_jax_tests", "peer_borrows"))
def test_fair_zero_own_candidate_max_share_preemptor(case):
    """The preemptor's CQ is the top borrower but has no candidate of its
    own (within_cluster_queue Never); the low-priority workloads sit in
    a lower-share peer under the borrowWithinCohort threshold. As in the
    JAX package's test, the peer does not borrow, so there are no
    candidates and both Schedulers keep to the CPU Preemptor; with a
    third, idle CQ in the cohort and the peer borrowing, the device
    scan must skip the candidate-less max-share CQ (it is never popped)
    and take the peer's."""
    peer = case == "peer_borrows"

    def setup(env):
        env.add_flavor("default")
        for name in ("a", "b", "c") if peer else ("a", "b"):
            env.add_cq(
                ClusterQueueWrapper(name).cohort("all")
                .preemption(
                    within_cluster_queue=japi.PREEMPTION_NEVER,
                    reclaim_within_cohort=japi.PREEMPTION_ANY,
                    borrow_within_cohort=japi.BorrowWithinCohort(
                        policy=japi.BORROW_WITHIN_COHORT_LOWER_PRIORITY))
                .resource_group(flavor_quotas("default", cpu="4")).obj(),
                f"lq-{name}")
        for w in cpu_workloads([(f"a{i}", "a", 50, float(i), "1")
                                for i in range(6)]
                               + [(f"b{i}", "b", -10, float(i), "1")
                                  for i in range(5 if peer else 2)],
                               reserve=True):
            env.admit_existing(w)

    got, sched = fair_preempt_run(setup, lambda: cpu_workloads(
        [("inc", "a", 5, 100.0, "2" if peer else "1")]),
        require_device=peer)
    if peer:
        assert sched.last_preempt_plan["fair"]["problems"] == 1
        assert set(preempted_reasons(got)) and all(
            r == [japi.IN_COHORT_RECLAIM_WHILE_BORROWING_REASON]
            for r in preempted_reasons(got).values())
    else:
        assert not got["evicted"] and sched.last_preempt_gate == "cpu"


def fair_preemption_env(pkg: str, preempt: str = "device"):
    """sim/northstar.build_fair_preemption's configuration at 16 CQs in 2
    cohorts (8 members, 7 borrowers of 12 victims each), built into an
    Env of either package from the same objects."""
    from kueue_tpu_torch.sim import northstar as ns
    env = Env(pkg, "device", fair_sharing=True, preempt=preempt)
    num_cqs, num_cohorts, victims = 16, 2, 12
    members = num_cqs // num_cohorts
    milli = (members * 8000 - 2000) // (members - 1) // victims
    env.add_flavor("f0")
    for i in range(num_cqs):
        cq = env.conv(ns.make_cq(f"cq{i}", f"cohort-{i % num_cohorts}",
                                 ["f0"], 8,
                                 preemption=ns.reclaim_preemption()))
        env.cache.add_cluster_queue(cq)
        env.queues.add_cluster_queue(cq)
        env.queues.add_local_queue(env.conv(ns.make_local_queue(
            f"lq{i}", f"cq{i}")))
        env.cq_names.append(f"cq{i}")
        if i >= num_cohorts:
            for v in range(victims):
                env.admit_existing(ns.victim_workload(
                    f"victim{i}-{v}", f"lq{i}", f"cq{i}", milli, 0,
                    float(v)))
        else:
            env.submit(ns.make_workload(f"preemptor{i}", f"lq{i}",
                                        cpu_units=8, priority=10,
                                        creation=1000.0))
    return env


def test_fair_preemption_configuration():
    """Two cycles of the fair-sharing preemption configuration: each
    cohort's preemptor drains the borrowers share by share (every
    reason InCohortFairSharing); the port's build_fair_preemption builds
    the same cluster and evicts the same."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    envs = [fair_preemption_env(pkg) for pkg in PKGS]
    for _ in range(2):
        for env in envs:
            env.cycle()
    ref, got = (observe(env) for env in envs)
    for k in ref:
        assert got[k] == ref[k], k
    plans = [env.scheduler.last_preempt_plan for env in envs]
    assert plans[1] == plans[0]
    assert plans[1]["fair"]["problems"] == 2
    assert plans[1]["fair"]["pool"] == 2 * 7 * 12
    reasons = {r for rs in preempted_reasons(got).values() for r in rs}
    assert reasons == {japi.IN_COHORT_FAIR_SHARING_REASON}
    cpu_env = fair_preemption_env("kueue_tpu_torch", preempt="cpu")
    for _ in range(2):
        cpu_env.cycle()
    cpu = observe(cpu_env)
    assert cpu["evicted"] == got["evicted"]
    assert cpu["applied"] == got["applied"]
    # northstar.build_fair_preemption gives the same first cycle
    sched, cache, queues, client = ns.build_fair_preemption(
        16, 2, solver=BatchSolver(device="cpu"))
    sched.solver_sync_floor_ms = 0.0
    sched.schedule(timeout=0)
    first = fair_preemption_env("kueue_tpu_torch")
    first.cycle()
    assert [k for k, _ in client.evictions] == [
        key.split("/")[1] for key in first.client.evicted]
    assert sched.last_preempt_plan == first.scheduler.last_preempt_plan


def mixed_setup(env):
    """One cohort, fair sharing: `own`'s preemptor has only candidates of
    its own CQ (reclaimWithinCohort Never: a minimal problem, K9);
    `claim`'s preemptor reclaims from the borrowing `lender` (a fair
    problem, K11)."""
    env.add_flavor("default")
    env.add_cq(ClusterQueueWrapper("own").cohort("all")
               .preemption(within_cluster_queue=japi.PREEMPTION_LOWER_PRIORITY,
                           reclaim_within_cohort=japi.PREEMPTION_NEVER)
               .resource_group(flavor_quotas("default", cpu="4")).obj(),
               "lq-own")
    env.add_cq(fair_cohort_cq("claim"), "lq-claim")
    env.add_cq(fair_cohort_cq("lender"), "lq-lender")
    for w in cpu_workloads([("own-low", "own", 0, 1.0, "3")]
                           + [(f"l{i}", "lender", 0, float(i), "2")
                              for i in range(4)], reserve=True):
        env.admit_existing(w)


def fair_cohort_cq(name, quota="4", bwc=None):
    return (ClusterQueueWrapper(name).cohort("all")
            .preemption(within_cluster_queue=japi.PREEMPTION_LOWER_PRIORITY,
                        reclaim_within_cohort=japi.PREEMPTION_ANY,
                        borrow_within_cohort=(japi.BorrowWithinCohort(
                            policy=bwc) if bwc else None))
            .resource_group(flavor_quotas("default", cpu=quota)).obj())


def test_fair_and_minimal_in_one_cycle():
    """A cycle with both kinds of problem: K9 and K11 run after the fit
    sync with one more sync for both, and the targets equal the JAX
    Scheduler's (minimal first, then fair) and the CPU Preemptor's."""
    envs = []
    syncs = []

    def workloads():
        return cpu_workloads([("own-high", "own", 10, 100.0, "3"),
                              ("claimant", "claim", 5, 101.0, "4")])
    real = BatchSolverSyncs.wrap(syncs)
    try:
        got, sched = fair_preempt_run(mixed_setup, workloads)
    finally:
        BatchSolverSyncs.unwrap(real)
    assert set(sched.last_preempt_plan) == {"minimal", "fair"}
    assert sched.last_preempt_plan["minimal"]["problems"] == 1
    assert sched.last_preempt_plan["fair"]["problems"] == 1
    reasons = preempted_reasons(got)
    assert reasons["default/own-low"] == [japi.IN_CLUSTER_QUEUE_REASON]
    assert any(r == [japi.IN_COHORT_RECLAMATION_REASON]
               or r == [japi.IN_COHORT_FAIR_SHARING_REASON]
               for k, r in reasons.items() if k != "default/own-low")
    # the device route's solve_preemptions: one sync for K9 and K11
    assert syncs and all(n == 1 for n in syncs)


class BatchSolverSyncs:
    """Records, for each solve_preemptions call of the port's
    BatchSolver, how many syncs it made."""

    @staticmethod
    def wrap(out: list):
        from kueue_tpu_torch.solver.service import BatchSolver
        real = BatchSolver.solve_preemptions

        def counted(self, *a, **kw):
            before = self.counters["syncs"]
            aux = real(self, *a, **kw)
            if aux and "preempt" in aux and "fair" in aux:
                out.append(self.counters["syncs"] - before)
            return aux
        BatchSolver.solve_preemptions = counted
        return real

    @staticmethod
    def unwrap(real) -> None:
        from kueue_tpu_torch.solver.service import BatchSolver
        BatchSolver.solve_preemptions = real
