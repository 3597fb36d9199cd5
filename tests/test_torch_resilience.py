"""The port's device-fault containment (kueue_tpu_torch/resilience and
its wiring in the Scheduler and BatchSolver) against the JAX package's.

Each class of kueue_tpu_torch/resilience is driven beside its JAX
counterpart on the same inputs: the injector's seeded schedules and its
actions, the breaker's transitions and jitter over a seeded sequence of
calls, the supervised worker's relay, timeout, respawn and orphan
discard, the watchdog's deadlines, the ladder's rungs over the same
synthetic cycle times. Then each package's Scheduler, with a BatchSolver
on the device route (the port's on the CPU, its kernels' plain
versions), runs the sync-path cases of tests/test_resilience.py
(:242-509) under the same scripted injector, and after every cycle the
route, the fault count, the breaker's state and counters, the admissions
and the evictions are equal; the ladder's cases of tests/test_degrade.py
(the head cap, survival and the probe, deferred preemption planning,
transitions over synthetic durations) likewise. A seeded chaos burst
over every site converges to the same admissions and usage per CQ as
the run without an injector. Last, the narrowing: a RuntimeError out of
the solver's dispatch propagates out of schedule() with no fault counted
and the breaker closed.
"""

import importlib
import random
import threading
import time

import pytest

from tests.test_solver import admitted_map
from tests.test_torch_scheduler import PKGS
from tests.test_torch_scheduler import Env as SchedEnv
from tests.wrappers import ClusterQueueWrapper, WorkloadWrapper, flavor_quotas

JAX, PORT = PKGS


def res(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.resilience.{name}")


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    for pkg in PKGS:
        res(pkg, "faultinject").uninstall()


# --- the injector ---

def test_scripted_schedules_equal_jax():
    for seed in range(8):
        for delay in (0.0, 0.2):
            for rates in (None, {"device_dispatch": 0.5,
                                 "arena_scatter": 0.4}):
                got = [res(pkg, "faultinject").FaultInjector.scripted(
                    seed, horizon=40, rates=rates, delay_s=delay).schedule
                       for pkg in PKGS]
                assert got[0] == got[1]
    a = res(PORT, "faultinject")
    assert a.FaultInjector.scripted(42).schedule \
        != a.FaultInjector.scripted(43).schedule
    assert a.SITES == res(JAX, "faultinject").SITES


@pytest.mark.parametrize("pkg", PKGS)
def test_injector_actions(pkg):
    fi = res(pkg, "faultinject")
    assert fi.active() is None
    payload = {"x": 1}
    assert fi.site(fi.SITE_COLLECT, payload) is payload  # disabled
    inj = fi.FaultInjector({fi.SITE_DISPATCH: {1: fi.RAISE},
                            fi.SITE_COLLECT: {0: fi.CORRUPT},
                            fi.SITE_SCATTER: {0: (fi.DELAY, 0.01)},
                            fi.SITE_REPLAY: {0: fi.CRASH}})
    with fi.installed(inj):
        fi.site(fi.SITE_DISPATCH)
        with pytest.raises(fi.InjectedFault) as exc:
            fi.site(fi.SITE_DISPATCH)
        assert (exc.value.site, exc.value.hit) == (fi.SITE_DISPATCH, 1)
        assert fi.site(fi.SITE_COLLECT, {"v": 1},
                       corrupt=lambda p: {"v": -p["v"]}) == {"v": -1}
        t0 = time.perf_counter()
        assert fi.site(fi.SITE_SCATTER, payload) is payload
        assert time.perf_counter() - t0 >= 0.01
        with pytest.raises(fi.InjectedCrash):
            fi.site(fi.SITE_REPLAY)
    assert fi.active() is None
    assert inj.fired == {**dict.fromkeys(fi.SITES, 0),
                         fi.SITE_DISPATCH: 1, fi.SITE_COLLECT: 1,
                         fi.SITE_SCATTER: 1, fi.SITE_REPLAY: 1}
    assert issubclass(fi.InjectedFault, fi.DeviceFault)
    assert not issubclass(fi.InjectedCrash, Exception)
    assert issubclass(res(pkg, "watchdog").DispatchTimeout, fi.DeviceFault)
    assert issubclass(res(pkg, "supervisor").SupervisedTimeout,
                      res(pkg, "watchdog").DispatchTimeout)
    with pytest.raises(ValueError):
        fi.FaultInjector({"not_a_site": {0: fi.RAISE}})
    # a scope isolates its injector from the global one
    with fi.installed(fi.FaultInjector({fi.SITE_DISPATCH: {0: fi.RAISE}})):
        with fi.scope("shard-0"):
            fi.site(fi.SITE_DISPATCH)  # no scoped injector: inert


# --- the breaker ---

@pytest.mark.parametrize("seed", range(6))
def test_breaker_transitions_equal_jax(seed):
    rng = random.Random(seed)
    kwargs = dict(threshold=rng.randint(1, 4),
                  backoff_base_s=rng.choice([0.5, 1.0, 2.0]),
                  backoff_max_s=rng.choice([3.0, 60.0]),
                  jitter=rng.choice([0.0, 0.1, 0.5]), seed=seed)
    breakers = [res(pkg, "breaker").CircuitBreaker(**kwargs) for pkg in PKGS]
    now = 0.0
    for step in range(300):
        now += rng.choice([0.0, 0.25, 1.0, 4.0])
        op = rng.choice(["allow", "allow", "fault", "success",
                         "inconclusive"])
        outs = []
        for b in breakers:
            if op == "allow":
                outs.append(b.allow_device(now))
            elif op == "fault":
                outs.append(b.record_fault(now))
            elif op == "success":
                outs.append(b.record_success(now))
            else:
                outs.append(b.probe_inconclusive(now))
        assert outs[0] == outs[1], (step, op)
        assert breakers[0].status() == breakers[1].status(), (step, op)
    assert breakers[1].trips > 0
    with pytest.raises(ValueError):
        res(PORT, "breaker").CircuitBreaker(threshold=0)


# --- the supervised worker ---

def supervisor_story(pkg: str) -> list:
    sup = res(pkg, "supervisor")
    w = sup.SupervisedWorker("t")
    out = [w.run(lambda x: x + 1, 1)]  # inline without a deadline
    out.append(w.run(lambda: threading.current_thread().name,
                     deadline_s=5.0))
    first = w._thread
    w.run(lambda: None, deadline_s=5.0)
    out.append(w._thread is first)  # the thread is reused

    class Boom(RuntimeError):
        pass

    def boom():
        raise Boom("x")
    with pytest.raises(Boom):  # relayed unchanged, never wrapped
        w.run(boom, deadline_s=5.0)
    orphan_done = threading.Event()
    late = []

    def hang():
        time.sleep(0.3)
        orphan_done.set()
        return "late"
    with pytest.raises(sup.SupervisedTimeout):
        w.run(hang, deadline_s=0.05)
    out.append((w.timeouts, w.orphaned))
    # a fresh worker answers while the orphan still sleeps
    out.append(w.run(lambda: "fresh", deadline_s=5.0))
    assert w._thread is not first
    orphan_done.wait(2.0)
    # the orphan's result went nowhere; the next call gets its own
    late.append(w.run(lambda: "next", deadline_s=5.0))
    out.append(late)
    out.append({k: v for k, v in w.status().items() if k != "alive"})
    w.close()
    return out


def test_supervisor_equal_jax():
    got = [supervisor_story(pkg) for pkg in PKGS]
    assert got[0] == got[1]
    assert got[1][1] == "t" and got[1][3] == (1, 1)


# --- the watchdog ---

def test_watchdog_deadlines_equal_jax():
    for kwargs in ({}, dict(safety_factor=2.0, min_deadline_s=0.1,
                            max_deadline_s=10.0),
                   dict(safety_factor=1.0, min_deadline_s=0.05,
                        max_deadline_s=0.3)):
        dogs = [res(pkg, "watchdog").DispatchWatchdog(**kwargs)
                for pkg in PKGS]
        for est in (None, 0.0, -1.0, 1e-4, 0.01, 0.2, 1.0, 5.0, 100.0):
            assert dogs[0].deadline_s(est) == dogs[1].deadline_s(est)
    wd = res(PORT, "watchdog")
    for bad in (dict(safety_factor=0), dict(min_deadline_s=0)):
        with pytest.raises(ValueError):
            wd.DispatchWatchdog(**bad)
    exc = wd.DispatchTimeout(0.1, 0.25)
    assert (exc.deadline_s, exc.waited_s) == (0.1, 0.25)


# --- the ladder ---

@pytest.mark.parametrize("seed", range(4))
def test_ladder_rungs_equal_jax(seed):
    rng = random.Random(seed)
    kwargs = dict(budget_s=0.1, shed_heads=rng.choice([2, 256]),
                  survival_heads=1, escalate_after=rng.randint(1, 3),
                  recovery_cycles=rng.randint(1, 3))
    ladders = [res(pkg, "degrade").DegradationLadder(**kwargs)
               for pkg in PKGS]
    states = set()
    for step in range(200):
        idle = rng.random() < 0.1
        dur = rng.choice([0.01, 0.05, 0.08, 0.12, 0.3])
        backlog = rng.choice([None, rng.randint(0, 50)])
        outs = [lad.observe_idle() if idle
                else lad.observe_cycle(dur, backlog=backlog)
                for lad in ladders]
        assert outs[0] == outs[1], step
        assert ladders[0].status() == ladders[1].status(), step
        assert ladders[0].head_cap() == ladders[1].head_cap()
        states.add(ladders[1].state)
    assert states == {"normal", "shed", "survival"}
    off = res(PORT, "degrade").DegradationLadder()
    assert not off.enabled and not off.observe_cycle(100.0, backlog=10)
    for bad in (dict(budget_s=-1), dict(shed_heads=0),
                dict(exit_factor=1.5, enter_factor=1.0),
                dict(recovery_cycles=0), dict(ewma_alpha=0)):
        with pytest.raises(ValueError):
            res(PORT, "degrade").DegradationLadder(**bad)


# --- the Schedulers under the same injector ---

def one_cq(env, cpu="100"):
    env.add_flavor("default")
    env.add_cq(ClusterQueueWrapper("cq")
               .resource_group(flavor_quotas("default", cpu=cpu)).obj(),
               "lq")


class Pair:
    """Each package's Scheduler (tests/test_torch_scheduler.Env, device
    route) with a tight, deterministic breaker and the default watchdog,
    driven by the same submissions, clock and injector schedule."""

    def __init__(self, setup=one_cq, threshold=3):
        self.envs = [SchedEnv(pkg, "device") for pkg in PKGS]
        for env in self.envs:
            s = env.scheduler
            s.breaker = res(env.pkg, "breaker").CircuitBreaker(
                threshold=threshold, backoff_base_s=2.0, jitter=0.0)
            s.watchdog = res(env.pkg, "watchdog").DispatchWatchdog()
            setup(env)
        self.injectors = None
        self.trace = []

    @property
    def port(self):
        return self.envs[1].scheduler

    def both(self, fn):
        return [fn(env) for env in self.envs]

    def submit(self, name, creation=0.0, cpu="2", queue="lq"):
        for env in self.envs:
            env.submit(WorkloadWrapper(name).queue(queue).creation(creation)
                       .pod_set(count=1, cpu=cpu).obj())

    def install(self, schedule):
        self.injectors = [res(pkg, "faultinject").FaultInjector(schedule)
                          for pkg in PKGS]

    def uninstall(self):
        self.injectors = None

    def watchdog(self, **kwargs):
        for env in self.envs:
            env.scheduler.watchdog = res(env.pkg, "watchdog") \
                .DispatchWatchdog(**kwargs)

    def advance(self, dt):
        for env in self.envs:
            env.clock.advance(dt)

    def cycle(self) -> dict:
        got = []
        for i, env in enumerate(self.envs):
            fi = res(env.pkg, "faultinject")
            s = env.scheduler
            before = dict(s.cycle_counts)
            if self.injectors is not None:
                fi.install(self.injectors[i])
            try:
                env.cycle()
            finally:
                fi.uninstall()
            route = [r for r, n in s.cycle_counts.items()
                     if n != before.get(r, 0)]
            b = s.breaker
            got.append(dict(
                route=route, faults=s.solver_faults, breaker=b.state,
                breaker_counts=(b.consecutive_faults, b.trips, b.recoveries,
                                b.faults),
                admitted=admitted_map(env),
                evicted=sorted(env.client.evicted),
                fired=(None if self.injectors is None
                       else dict(self.injectors[i].fired))))
        assert got[0] == got[1], got
        self.trace.append(got[1])
        return got[1]


def test_dispatch_fault_falls_back_to_cpu_same_decisions():
    p = Pair()
    p.submit("w")
    p.install({"device_dispatch": {0: "raise"}})
    out = p.cycle()
    assert "default/w" in out["admitted"] and out["route"] == ["device"]
    assert out["faults"] == 1 and out["breaker"] == "closed"
    assert out["breaker_counts"][0] == 1


def test_replay_fault_reestablishes_residency():
    p = Pair()
    p.submit("w0")
    p.cycle()
    assert p.port.solver.resident is not None
    p.submit("w1", 1.0)
    p.install({"journal_replay": {0: "raise"}})
    out = p.cycle()
    p.uninstall()
    assert "default/w1" in out["admitted"] and out["faults"] == 1
    p.submit("w2", 2.0)
    out = p.cycle()
    assert "default/w2" in out["admitted"]
    assert p.port.solver.resident is not None


def test_corrupted_collect_is_detected_not_admitted():
    p = Pair()
    p.submit("w")
    p.install({"device_collect": {0: "corrupt"}})
    out = p.cycle()
    p.uninstall()
    assert p.both(lambda e: e.scheduler.solver.counters[
        "validation_faults"]) == [1, 1]
    assert out["faults"] == 1
    # the corrupt decisions admitted nothing: the CPU nominated the head
    assert "default/w" in out["admitted"]
    p.cycle()


def test_watchdog_timeout_abandons_the_collect():
    p = Pair()
    for env in p.envs:
        env.scheduler.solver.supervise_dispatch = False
    p.watchdog(safety_factor=1.0, min_deadline_s=0.05, max_deadline_s=0.1)
    p.submit("w")
    p.install({"device_collect": {0: ("delay", 0.3)}})
    out = p.cycle()
    p.uninstall()
    counters = p.both(lambda e: (
        e.scheduler.solver.counters["dispatch_timeouts"],
        e.scheduler.solver.counters["supervised_timeouts"]))
    assert counters == [(1, 0), (1, 0)]
    assert out["faults"] == 1
    assert p.port.solver.resident is None  # residency dropped
    assert "default/w" in out["admitted"]
    p.submit("w2", 1.0)
    assert "default/w2" in p.cycle()["admitted"]


def test_breaker_trips_routes_cpu_breaker_and_recovers():
    p = Pair(threshold=2)
    p.install({"device_dispatch": {0: "raise", 1: "raise"}})
    for i in range(2):
        p.submit(f"w{i}", float(i))
        assert f"default/w{i}" in p.cycle()["admitted"]
    assert p.trace[-1]["breaker"] == "open"
    p.submit("w2", 2.0)
    out = p.cycle()
    assert out["route"] == ["cpu-breaker"] and "default/w2" in out["admitted"]
    p.advance(10.0)  # past the backoff: a half-open probe on the device
    p.submit("w3", 3.0)
    out = p.cycle()
    p.uninstall()
    assert out["route"] == ["device"] and out["breaker"] == "closed"
    assert out["breaker_counts"][2] == 1
    assert p.both(lambda e: e.scheduler.breaker.last_recovery_cycles) \
        == [2, 2]


def test_failed_probe_reopens_with_longer_backoff():
    p = Pair(threshold=1)
    p.install({"device_dispatch": {0: "raise", 1: "raise"}})
    p.submit("w0")
    p.cycle()
    p.advance(3.0)
    p.submit("w1", 1.0)
    out = p.cycle()  # the probe faults too: reopened, backoff doubled
    p.uninstall()
    assert out["breaker"] == "open" and "default/w1" in out["admitted"]
    p.advance(3.0)  # within the doubled backoff
    p.submit("w2", 2.0)
    assert p.cycle()["route"] == ["cpu-breaker"]
    p.advance(2.0)
    p.submit("w3", 3.0)
    assert p.cycle()["breaker"] == "closed"


def test_survival_does_not_consume_the_probe():
    # the port's counterpart of the strict-bound case: a gate that
    # routes the cycle off the device is consulted before the breaker
    p = Pair(threshold=1)
    p.install({"device_dispatch": {0: "raise"}})
    p.submit("w0")
    p.cycle()
    p.uninstall()
    p.advance(10.0)
    for env in p.envs:
        lad = res(env.pkg, "degrade").DegradationLadder(budget_s=1.0)
        lad.state = "survival"
        env.scheduler.ladder = lad
    p.submit("w1", 1.0)
    out = p.cycle()
    assert out["route"] == ["cpu-survival"] and out["breaker"] == "open"
    for env in p.envs:
        env.scheduler.ladder.state = "normal"
    p.submit("w2", 2.0)
    out = p.cycle()
    assert out["route"] == ["device"] and out["breaker"] == "closed"


def test_dispatch_hang_is_supervised_not_a_freeze():
    p = Pair()
    for i, name in enumerate(("warm-a", "warm-b")):
        p.submit(name, float(i))
        p.cycle()
    p.watchdog(safety_factor=1.0, min_deadline_s=0.05, max_deadline_s=0.3)
    p.submit("w", 2.0)
    p.install({"device_dispatch": {0: ("delay", 2.0)}})
    t0 = time.perf_counter()
    out = p.cycle()
    assert time.perf_counter() - t0 < 4.0  # two Schedulers, not 2 x 2 s
    p.uninstall()
    assert p.both(lambda e: (
        e.scheduler.solver.counters["supervised_timeouts"],
        e.scheduler.solver._supervisor.orphaned)) == [(1, 1), (1, 1)]
    assert out["faults"] == 1 and "default/w" in out["admitted"]
    assert p.port.solver.resident is None
    assert p.port.solver._dispatch_epoch == 1
    p.watchdog()
    p.submit("w2", 3.0)
    assert "default/w2" in p.cycle()["admitted"]


def test_supervision_disabled_runs_inline():
    p = Pair()
    for env in p.envs:
        env.scheduler.solver.supervise_dispatch = False
    p.watchdog(safety_factor=1.0, min_deadline_s=0.05, max_deadline_s=0.1)
    p.submit("w")
    p.install({"device_dispatch": {0: ("delay", 0.2)}})
    out = p.cycle()  # inline: the delay is sat out, no fault
    assert out["faults"] == 0 and "default/w" in out["admitted"]
    assert p.port.solver.counters["supervised_timeouts"] == 0


def test_scatter_raise_drops_the_twin():
    # a raise at the arena scatter (a failed upload) is a dispatch fault
    p = Pair()
    p.submit("w0")
    p.cycle()
    p.submit("w1", 1.0)  # a changed row: the next dispatch scatters it
    p.install({"arena_scatter": {0: "raise"}})
    out = p.cycle()
    p.uninstall()
    assert out["faults"] == 1 and "default/w1" in out["admitted"]
    assert p.port.solver.arena.dev is None
    p.submit("w2", 2.0)
    assert "default/w2" in p.cycle()["admitted"]


def test_port_catches_a_scrambled_scatter():
    # the port raises the noted scramble at collect (the JAX package
    # denies the mangled rows through its host router without counting
    # a fault)
    env = SchedEnv(PORT, "device")
    one_cq(env)
    fi = res(PORT, "faultinject")
    s = env.scheduler
    env.submit(WorkloadWrapper("w0").queue("lq").pod_set(count=1, cpu="2")
               .obj())
    env.cycle()
    env.submit(WorkloadWrapper("w1").queue("lq").creation(1.0)
               .pod_set(count=1, cpu="2").obj())
    heard = []
    s.on_fault = lambda kind, msg: heard.append((kind, msg))
    with fi.installed(fi.FaultInjector({fi.SITE_SCATTER: {0: fi.CORRUPT}})):
        env.cycle()
    assert [kind for kind, _ in heard] == ["fault"]
    assert heard[0][1].endswith("injected fault at arena_scatter (hit 0)")
    assert s.solver.counters["scatter_faults"] == 1
    assert s.solver_faults == 1 and s.solver.resident is None
    assert "default/w1" in admitted_map(env)  # nominated on the CPU
    env.submit(WorkloadWrapper("w2").queue("lq").creation(2.0)
               .pod_set(count=1, cpu="2").obj())
    env.cycle()
    assert "default/w2" in admitted_map(env)
    assert s.solver_faults == 1 and s.solver.resident is not None


def test_unscrambled_scatters_raise_nothing():
    # a scatter the injector passes untouched is no fault: only the hit
    # that scrambled its rows is raised, with its hit number
    env = SchedEnv(PORT, "device")
    one_cq(env)
    fi = res(PORT, "faultinject")
    s = env.scheduler
    heard = []
    s.on_fault = lambda kind, msg: heard.append(msg)
    env.submit(WorkloadWrapper("w0").queue("lq").pod_set(count=1, cpu="1")
               .obj())
    env.cycle()
    with fi.installed(fi.FaultInjector({fi.SITE_SCATTER: {1: fi.CORRUPT}})):
        for i in (1, 2):
            env.submit(WorkloadWrapper(f"w{i}").queue("lq").creation(
                float(i)).pod_set(count=1, cpu="1").obj())
            env.cycle()
            if i == 1:
                assert s.solver_faults == 0 and not heard
                assert s.solver.arena.last_scramble is None
    assert s.solver.counters["scatter_faults"] == 1 and s.solver_faults == 1
    assert len(heard) == 1 and heard[0].endswith(
        "injected fault at arena_scatter (hit 1)")
    assert {"default/w1", "default/w2"} <= set(admitted_map(env))


# --- the ladder through the Schedulers ---

def ladder_pair(n_cqs=4, cpu="100", preemption=False, solver=True):
    from kueue_tpu.api import kueue as japi

    def setup(env):
        env.add_flavor("default")
        for i in range(n_cqs):
            cq = ClusterQueueWrapper(f"cq{i}").cohort("co")
            if preemption:
                cq = cq.preemption(
                    within_cluster_queue=japi.PREEMPTION_LOWER_PRIORITY)
            env.add_cq(cq.resource_group(
                flavor_quotas("default", cpu=cpu)).obj(), f"lq-cq{i}")
    p = Pair(setup)
    if not solver:
        for env in p.envs:
            env.scheduler.solver = None
    return p


def submit_all(p, n_cqs=4, cpu="2", priority=0):
    for i in range(n_cqs):
        for env in p.envs:
            env.submit(WorkloadWrapper(f"w{i}").queue(f"lq-cq{i}")
                       .priority(priority).creation(float(i))
                       .pod_set(count=1, cpu=cpu).obj())


def set_ladder(p, state, **kwargs):
    for env in p.envs:
        lad = res(env.pkg, "degrade").DegradationLadder(budget_s=1.0,
                                                        **kwargs)
        lad.state = state
        env.scheduler.ladder = lad


@pytest.mark.parametrize("solver", [False, True])
def test_shed_caps_heads_and_requeues_extras(solver):
    p = ladder_pair(solver=solver)
    set_ladder(p, "shed", shed_heads=2)
    submit_all(p)
    out = p.cycle()
    assert set(out["admitted"]) == {"default/w0", "default/w1"}
    assert p.both(lambda e: e.scheduler.shed_heads_requeued) == [2, 2]
    out = p.cycle()
    assert set(out["admitted"]) == {f"default/w{i}" for i in range(4)}


def test_shed_cap_keeps_high_priority_over_older_heads():
    p = ladder_pair(solver=False)
    set_ladder(p, "shed", shed_heads=1)
    submit_all(p)
    for env in p.envs:
        env.submit(WorkloadWrapper("hot").queue("lq-cq0").priority(100)
                   .creation(99.0).pod_set(count=1, cpu="2").obj())
    assert "default/hot" in p.cycle()["admitted"]


def test_survival_pins_cpu_survival_route():
    p = ladder_pair()
    set_ladder(p, "survival", survival_heads=2)
    submit_all(p)
    out = p.cycle()
    assert out["route"] == ["cpu-survival"] and len(out["admitted"]) == 2


@pytest.mark.parametrize("solver", [False, True])
def test_shed_defers_preempt_planning(solver):
    p = ladder_pair(n_cqs=1, cpu="8", preemption=True, solver=solver)
    for env in p.envs:
        env.admit_existing(
            WorkloadWrapper("victim").queue("lq-cq0").priority(0)
            .pod_set(count=1, cpu="8").reserve("cq0").obj())
        env.submit(WorkloadWrapper("pre").queue("lq-cq0").priority(10)
                   .creation(1.0).pod_set(count=1, cpu="8").obj())
    set_ladder(p, "shed")
    out = p.cycle()
    assert not out["evicted"]
    assert p.both(lambda e: e.scheduler.preempt_plans_deferred) == [1, 1]
    for env in p.envs:
        env.scheduler.ladder.state = "normal"
    assert "default/victim" in p.cycle()["evicted"]


def test_ladder_transitions_over_synthetic_durations():
    p = ladder_pair(n_cqs=4)
    events = {env.pkg: [] for env in p.envs}
    durations = [0.5, 2.0, 2.5, 3.0, 3.0, 3.0] + [0.1] * 14
    for env in p.envs:
        s = env.scheduler
        s.ladder = res(env.pkg, "degrade").DegradationLadder(
            budget_s=1.0, shed_heads=3, survival_heads=2)
        real = s._observe_budget
        feed = iter(durations)
        s._observe_budget = (lambda d, h, a, real=real, feed=feed:
                             real(next(feed), h, a))
        s.on_fault = (lambda kind, msg, out=events[env.pkg]:
                      out.append(kind))
    states = []
    for k in range(len(durations)):
        for env in p.envs:
            for i in range(4):
                env.submit(WorkloadWrapper(f"c{k}-{i}").queue(f"lq-cq{i}")
                           .creation(float(100 * k + i))
                           .pod_set(count=1, cpu="1").obj())
        p.cycle()
        got = p.both(lambda e: e.scheduler.ladder.status())
        assert got[0] == got[1], k
        states.append(got[1]["state"])
    assert events[JAX] == events[PORT]
    assert {"shed", "survival", "normal"} <= set(states)
    assert "degrade" in events[PORT] and "degrade-recovered" in events[PORT]


# --- a seeded chaos burst (tests/test_chaos.py:172-180) ---

def chaos_setup(env):
    env.add_flavor("default")
    for i in range(4):
        env.add_cq(ClusterQueueWrapper(f"cq{i}").cohort("co")
                   .resource_group(flavor_quotas("default", cpu="8")).obj(),
                   f"lq-cq{i}")


def chaos_waves(env, waves, start_wave=0):
    n = start_wave * 4
    for wave in range(start_wave, start_wave + waves):
        for i in range(4):
            env.submit(WorkloadWrapper(f"w{wave}-{i}").queue(f"lq-cq{i}")
                       .creation(float(n)).pod_set(count=1, cpu="2").obj())
            n += 1


def run_to_settled(env, injector=None, inject_cycles=14, trickle_waves=4,
                   max_cycles=80) -> int:
    fi = res(env.pkg, "faultinject")
    settled = 0
    for cycle in range(max_cycles):
        if cycle < trickle_waves:
            chaos_waves(env, 1, start_wave=2 + cycle)
        injecting = injector is not None and cycle < inject_cycles
        if injecting:
            fi.install(injector)
        before = len(env.client.applied) + len(env.client.evicted)
        try:
            env.cycle()
        finally:
            fi.uninstall()
        env.clock.advance(1.0)
        progressed = (len(env.client.applied) + len(env.client.evicted)
                      > before)
        settled = 0 if (progressed or injecting) else settled + 1
        if settled >= 3:
            return cycle + 1
    raise AssertionError("did not settle")


def usage_per_cq(cache) -> dict:
    return {name: sorted((tuple(fr), v)
                         for fr, v in cqc.resource_node.usage.items())
            for name, cqc in cache.hm.cluster_queues.items()}


def chaos_env(pkg, seed):
    env = SchedEnv(pkg, "device")
    s = env.scheduler
    s.breaker = res(pkg, "breaker").CircuitBreaker(
        threshold=2, backoff_base_s=2.0, jitter=0.0, seed=seed)
    s.watchdog = res(pkg, "watchdog").DispatchWatchdog(
        safety_factor=2.0, min_deadline_s=0.1, max_deadline_s=10.0)
    chaos_setup(env)
    chaos_waves(env, 2)
    return env


def test_seeded_chaos_burst_converges_to_the_uninjected_run():
    seed = 1234
    rates = {"device_dispatch": 0.5, "device_collect": 0.3,
             "arena_scatter": 0.4, "journal_replay": 0.2}
    oracle = chaos_env(PORT, seed)
    run_to_settled(oracle)
    jax_oracle = chaos_env(JAX, seed)
    run_to_settled(jax_oracle)
    env = chaos_env(PORT, seed)
    injector = res(PORT, "faultinject").FaultInjector.scripted(
        seed, horizon=40, rates=rates, delay_s=0.2)
    run_to_settled(env, injector)
    s = env.scheduler
    assert injector.total_fired > 0 and s.solver_faults > 0
    for other in (oracle, jax_oracle):
        assert set(admitted_map(env)) == set(admitted_map(other))
        assert set(env.client.evicted) == set(other.client.evicted)
        assert usage_per_cq(env.cache) == usage_per_cq(other.cache)
    # the persistent snapshot is unpoisoned
    from tests.test_incremental_snapshot import assert_snapshots_equal
    assert_snapshots_equal(env.cache.snapshot(), env.cache._build_snapshot(),
                           "post-chaos")


# --- what is not contained ---

def test_runtime_error_from_dispatch_propagates():
    env = SchedEnv(PORT, "device")
    one_cq(env)
    s = env.scheduler
    env.submit(WorkloadWrapper("w0").queue("lq").pod_set(count=1, cpu="2")
               .obj())
    env.cycle()
    live0 = env.cache.live_handouts

    def boom(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")
    s.solver._dispatch_body = boom
    env.submit(WorkloadWrapper("w1").queue("lq").creation(1.0)
               .pod_set(count=1, cpu="2").obj())
    with pytest.raises(RuntimeError, match="illegal memory") as exc:
        env.cycle()
    # relayed from the supervised worker unchanged, never wrapped
    assert type(exc.value) is RuntimeError
    assert s.solver_faults == 0 and s.breaker.state == "closed"
    assert s.breaker.consecutive_faults == 0
    del s.solver._dispatch_body
    # the aborted cycle's snapshot handout is released by the next one
    env.submit(WorkloadWrapper("w2").queue("lq").creation(2.0)
               .pod_set(count=1, cpu="2").obj())
    env.cycle()
    assert env.cache.live_handouts == live0 == 0
    assert "default/w2" in admitted_map(env)


def test_defaults():
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    s, cache, _, _ = ns.build_scheduler(4, 2, ["f0"], 4,
                                        solver=BatchSolver(device="cpu"))
    assert s.breaker.state == "closed" and s.watchdog is not None
    assert s._supervise_deadline() == s.watchdog.max_deadline_s == 30.0
    assert s._dispatch_deadline() == 30.0  # no sample yet: the cold clamp
    assert not s.ladder.enabled
    assert s.solver.supervise_dispatch
    assert cache._maintainer is not None


@pytest.mark.parametrize("wedge", ("site", "before_launch", "in_upload"))
def test_abandoned_dispatch_writes_nothing(wedge, monkeypatch):
    """A supervised dispatch wedged past its deadline (at its fault site,
    after its uploads before the cycle's launches, or inside the arena
    upload) is abandoned and moves the epoch; when the orphan wakes it
    leaves the resident usage, the cycle state and the arena twin as
    they were (a wedge inside the upload drops the twin instead, which
    the next dispatch uploads whole)."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    fi = res(PORT, "faultinject")
    flavors = ["f0", "f1"]
    cache, queues = ns.build_cluster(16, 4, flavors, 40)
    ns.stage_waves(queues, 3, 16, 40)
    solver = BatchSolver(device="cpu")
    solver.bind_cache(cache)
    solver.bind_queues(queues)

    def cycle(n, **kwargs):
        heads = queues.heads_nonblocking()
        snapshot = cache.snapshot()
        plan = solver.prepare(snapshot, heads)
        got = solver.solve_prepared(plan, snapshot, **kwargs)[0]
        ns.apply_decisions(cache, queues, solver, heads, got, float(n))
        return heads, got
    cycle(0)
    rs, state = solver.resident, solver._cycle_state
    woke = threading.Event()
    real_check = solver._check_epoch

    def check(epoch):
        try:
            real_check(epoch)
        except fi.DeviceFault:
            woke.set()
            raise
    monkeypatch.setattr(solver, "_check_epoch", check)
    if wedge == "site":
        fi.install(fi.FaultInjector({fi.SITE_DISPATCH: {0: (fi.DELAY, 0.5)}}))
    else:
        name = "_sync" if wedge == "before_launch" else "prepare_device"
        owner = solver if wedge == "before_launch" else solver.arena
        real = getattr(owner, name)

        def wedged(*args):
            out = real(*args)
            if threading.current_thread().name == "solver-dispatch":
                time.sleep(0.5)
            return out
        monkeypatch.setattr(owner, name, wedged)
    heads = queues.heads_nonblocking()
    snapshot = cache.snapshot()
    plan = solver.prepare(snapshot, heads)
    try:
        with pytest.raises(res(PORT, "supervisor").SupervisedTimeout):
            solver.solve_prepared(plan, snapshot, deadline_s=5.0,
                                  supervise_deadline_s=0.1)
    finally:
        fi.uninstall()
    usage = rs.usage_dev.clone()
    twin = (None if solver.arena.dev is None
            else {k: v.clone() for k, v in solver.arena.dev.items()})
    assert solver._dispatch_epoch == 1
    assert solver.counters["supervised_timeouts"] == 1
    if wedge == "in_upload":
        # the upload's own check: the orphan drops the twin and bails
        t0 = time.perf_counter()
        while solver.arena.dev is not None and time.perf_counter() - t0 < 5:
            time.sleep(0.01)
    else:
        assert woke.wait(5.0)
    time.sleep(0.05)
    assert solver.resident is rs and solver._cycle_state is state
    assert torch_equal(rs.usage_dev, usage)
    if wedge == "in_upload":
        assert solver.arena.dev is None
    else:
        for k, v in twin.items():
            assert torch_equal(solver.arena.dev[k], v), k
    # the Scheduler's fault path, then the next cycle re-establishes
    solver.invalidate_resident()
    for info in heads:
        queues.requeue_workload(info, ns.RequeueReason.GENERIC)
    monkeypatch.undo()
    _, got = cycle(2, supervise_deadline_s=5.0)
    assert got and solver.resident is not rs


def torch_equal(a, b) -> bool:
    import torch
    return torch.equal(a, b)


def test_parked_worker_holds_no_request():
    """After a call, the parked worker keeps neither the callable nor its
    arguments alive (a solver's bound method and plan would pin the
    solver's cache and queues), and a worker its owner drops ends its
    thread."""
    import gc
    import weakref
    sup = res(PORT, "supervisor")

    class Owner:
        def work(self, x):
            return x * 2

    owner = Owner()
    w = sup.SupervisedWorker("park")
    assert w.run(owner.work, 21, deadline_s=5.0) == 42
    thread = w._thread
    ref = weakref.ref(owner)
    del owner
    gc.collect()
    assert ref() is None
    del w
    gc.collect()
    thread.join(timeout=5.0)
    assert not thread.is_alive()
