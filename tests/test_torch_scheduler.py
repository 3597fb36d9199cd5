"""The port's Scheduler against the JAX package's, cycle by cycle.

Each scenario is built twice from the same objects: with the JAX
package's api, cache, queue Manager and Scheduler, and, converted field
by field into the port's api, with the port's (`to_pkg`). Both run the
same cycles on the same route:

- "device": a BatchSolver (the port's on the CPU, its kernels' plain
  versions) and solver_min_heads=0, so every cycle takes the solve
  stage; the JAX Scheduler's preemption work gate is pinned to the CPU
  Preemptor, as the port's device route uses it;
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
configuration at 16 ClusterQueues in 4 cohorts with completions.
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
    BatchSolver on the given route."""

    def __init__(self, pkg: str, route: str, fair_sharing=False):
        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")
        self.pkg = pkg
        self.wlpkg = mod("core.workload")
        self.clock = mod("api.meta").FakeClock(1000.0)
        self.cache = mod("cache").Cache()
        self.queues = mod("queue").Manager(clock=self.clock)
        self.client = FakeClient(self.wlpkg)
        solver_cls = mod("solver").BatchSolver
        solver = solver_cls(device="cpu") if pkg == "kueue_tpu_torch" \
            else solver_cls()
        self.scheduler = mod("scheduler.scheduler").Scheduler(
            self.queues, self.cache, self.client, clock=self.clock,
            fair_sharing_enabled=fair_sharing, solver=solver,
            solver_min_heads=0 if route == "device" else 64)
        if pkg == "kueue_tpu":
            # the CPU Preemptor for every preempt-mode entry, and no
            # watchdog deadline on the first compile
            self.scheduler.preempt_cand_us = 0.0
            self.scheduler.fair_cand_us = 0.0
            self.scheduler.solver_sync_floor_ms = 0.0
            self.scheduler.watchdog = None
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
             between=None, admissions_only=False):
    """The scenario on both packages; returns the two observations after
    asserting they are equal, and the port's Env."""
    envs = [Env(pkg, route, fair_sharing) for pkg in PKGS]
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

    run_both(setup, workloads, route, fair_sharing=True, cycles=2)


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
    """On the device route the JAX Scheduler searches the counts with
    its batched partial admission and the port with the CPU reducer:
    the admissions are compared, not the messages of the failed
    probes."""
    def workloads():
        return [WorkloadWrapper("w").queue("lq")
                .pod_set(count=10, min_count=2, cpu="1").obj(),
                WorkloadWrapper("x").queue("lq").priority(-1)
                .pod_set(count=3, min_count=1, cpu="4").obj()]

    got, _ = run_both(simple_setup("6"), workloads, route, cycles=2,
                      admissions_only=route == "device")
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
