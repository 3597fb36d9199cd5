"""The port's routing against the JAX Scheduler's: the starvation bound
("cpu-strict"), adaptive routing and leader_check / cq_filter.

Every scenario runs on both packages through tests/test_torch_scheduler.py's
Env (the JAX package on JAX-CPU with x64, the port on the CPU with its
kernels' plain versions) and is held equal with no tolerance:

- the starvation bound: tests/test_solver.py TestStarvationBound's
  scenario over 24 cycles at the default bound (8), at 3 and at 0 (both
  starve), with device preemption: the cycle the preemptor admits, the
  cycle_counts and the streak after every cycle; the bound cases of
  tests/test_scheduler.py (eviction churn keeps the streak at zero, an
  overlap-skipped preemptor is not blocked, a truly blocked one ratchets,
  the decay after the grace, sparse re-attempts reach the bound),
  tests/test_degrade.py's deferred plan (no ratchet) and
  tests/test_resilience.py's strict route that does not take the
  breaker's half-open probe;
- adaptive routing: the same samples fed to both routers give the same
  choice over 240 calls a regime (the 2-sample start, a losing engine
  probed every 16 cycles, a hopeless one every 64, no sample from a
  degraded cycle or an intervention route); "never" and "adaptive"
  (with the samples' seconds fixed per engine, so the choice does not
  hang on the host's clock) over the fair-sharing and random preemption
  scenarios make the same admissions and routes;
- leader_check: a flip mid-pipeline (depth 1 and 2) abandons the
  in-flight cycles undecoded and requeues their heads, and nothing is
  admitted twice; cq_filter: a filtered pop equals the JAX Manager's and
  a filtered Scheduler admits only its CQs' heads.
"""

import importlib

import pytest

from kueue_tpu.api import kueue as japi
from tests.test_torch_pipeline import N_CQS, Pipe, quota_reserved_counts
from tests.test_torch_scheduler import (
    PKGS,
    PREEMPT_SEEDS,
    Env,
    fair_sharing_scenario,
    observe,
    random_preempt_scenario,
)
from tests.wrappers import ClusterQueueWrapper, WorkloadWrapper, flavor_quotas


def pair(route="device", preempt="device", setup=None, **kw):
    envs = [Env(pkg, route, preempt=preempt, **kw) for pkg in PKGS]
    if setup is not None:
        for env in envs:
            setup(env)
    return envs


# --- the starvation bound (tests/test_solver.py TestStarvationBound) ---

def bound_setup(env):
    env.add_flavor("default")
    env.add_cq(ClusterQueueWrapper("cq-a").cohort("team")
               .preemption(within_cluster_queue=japi.PREEMPTION_NEVER,
                           reclaim_within_cohort=japi.PREEMPTION_LOWER_PRIORITY)
               .resource_group(flavor_quotas("default", cpu=(10, 0))).obj(),
               "lq-a")
    env.add_cq(ClusterQueueWrapper("cq-b").cohort("team")
               .resource_group(flavor_quotas("default", cpu=10)).obj(),
               "lq-b")


def drive_bound(env, strict_after, cycles=24):
    """TestStarvationBound._drive: returns (the cycle the preemptor
    admitted or None, the streak after every cycle)."""
    if strict_after is not None:
        env.scheduler.strict_after_blocked_cycles = strict_after
    occupant = env.conv(WorkloadWrapper("occupant").queue("lq-a")
                        .priority(200).pod_set(count=1, cpu=4)
                        .reserve("cq-a").obj())
    env.cache.add_or_update_workload(occupant)
    env.admit_existing(WorkloadWrapper("base").queue("lq-b").priority(200)
                       .pod_set(count=1, cpu=10).reserve("cq-b").obj())
    env.submit(WorkloadWrapper("preemptor").queue("lq-a").priority(100)
               .creation(1).pod_set(count=1, cpu=10).obj())
    streaks = []
    for i in range(cycles):
        prev = env.client.applied.pop(f"default/fitter{i - 2}", None)
        if prev is not None:
            env.cache.delete_workload(prev)
        if i == 3:
            env.cache.delete_workload(occupant)
        env.submit(WorkloadWrapper(f"fitter{i}").queue("lq-b").priority(200)
                   .creation(10.0 + i).pod_set(count=1, cpu=2).obj())
        env.queues.queue_inadmissible_workloads({"cq-a", "cq-b"})
        env.cycle()
        streaks.append(env.scheduler._blocked_preempt_streak)
        if "default/preemptor" in env.client.applied:
            return i, streaks
    return None, streaks


@pytest.mark.parametrize("bound,want_cycle,want_counts", [
    (None, 9, {"device": 8, "cpu-strict": 2}),
    (3, 4, {"device": 3, "cpu-strict": 2}),
    (0, None, {"device": 24}),
])
def test_starvation_bound(bound, want_cycle, want_counts):
    """At the default bound the JAX Scheduler admits the blocked
    preemptor at cycle 9 after two cpu-strict cycles; the port must do
    the same (before the bound was ported it never admitted it)."""
    envs = pair(setup=bound_setup)
    got = [drive_bound(env, bound) for env in envs]
    assert envs[1].scheduler.strict_after_blocked_cycles == (
        8 if bound is None else bound)
    assert got[1] == got[0]
    assert got[0][0] == want_cycle
    for env in envs:
        assert env.scheduler.cycle_counts == want_counts
    assert observe(envs[1]) == observe(envs[0])


def preempt_cq(env, name="cq", cpu="10"):
    env.add_cq(ClusterQueueWrapper(name)
               .preemption(within_cluster_queue=japi.PREEMPTION_LOWER_PRIORITY)
               .resource_group(flavor_quotas("default", cpu=cpu)).obj(),
               "lq")


def test_eviction_churn_keeps_streak_at_zero():
    """tests/test_scheduler.py:572: a preemptor that evicts is
    progressing; the streak stays 0 and cpu-strict never engages."""
    envs = pair()
    for env in envs:
        env.add_flavor("default")
        preempt_cq(env)
        env.scheduler.strict_after_blocked_cycles = 4
    trail = [[] for _ in envs]
    for i in range(10):
        for k, env in enumerate(envs):
            victim = env.conv(WorkloadWrapper(f"victim{i}").queue("lq")
                              .priority(0).pod_set(count=1, cpu="10")
                              .reserve("cq").obj())
            env.cache.add_or_update_workload(victim)
            env.submit(WorkloadWrapper(f"preemptor{i}").queue("lq")
                       .priority(100).creation(float(i))
                       .pod_set(count=1, cpu="10").obj())
            env.cycle()
            trail[k].append(("evict", f"default/victim{i}" in
                             env.client.evicted,
                             env.scheduler._blocked_preempt_streak))
            env.cache.delete_workload(victim)
            env.queues.queue_inadmissible_workloads({"cq"})
            env.cycle()
            admitted = env.client.applied.pop(f"default/preemptor{i}", None)
            trail[k].append(("admit", admitted is not None,
                             env.scheduler._blocked_preempt_streak))
            if admitted is not None:
                env.cache.delete_workload(admitted)
    assert trail[1] == trail[0]
    assert all(ok and streak == 0 for _, ok, streak in trail[0])
    for env in envs:
        assert "cpu-strict" not in env.scheduler.cycle_counts


def test_overlap_skipped_preemptor_is_not_blocked():
    envs = pair()
    for env in envs:
        env.add_flavor("default")
        preempt_cq(env)
        env.admit_existing(WorkloadWrapper("victim").queue("lq").priority(0)
                           .pod_set(count=1, cpu="10").reserve("cq").obj())
        for name, ts in (("pre-a", 1.0), ("pre-b", 2.0)):
            env.submit(WorkloadWrapper(name).queue("lq").priority(100)
                       .creation(ts).pod_set(count=1, cpu="10").obj())
        env.cycle()
        assert "default/victim" in env.client.evicted
        assert env.scheduler._blocked_preempt_streak == 0
    assert observe(envs[1]) == observe(envs[0])


def blocked_setup(env, side=False):
    env.add_flavor("default")
    preempt_cq(env)
    if side:
        env.add_cq(ClusterQueueWrapper("side").resource_group(
            flavor_quotas("default", cpu="100")).obj(), "lq-side")
    env.admit_existing(WorkloadWrapper("occupant").queue("lq").priority(200)
                       .pod_set(count=1, cpu="10").reserve("cq").obj())


def preemptor():
    return (WorkloadWrapper("preemptor").queue("lq").priority(100)
            .creation(1.0).pod_set(count=1, cpu="10").obj())


def test_truly_blocked_preemptor_still_feeds_the_bound():
    envs = pair(setup=blocked_setup)
    streaks = [[] for _ in envs]
    for k, env in enumerate(envs):
        env.submit(preemptor())
        for _ in range(3):
            env.cycle()
            env.queues.queue_inadmissible_workloads({"cq"})
            streaks[k].append(env.scheduler._blocked_preempt_streak)
    assert streaks[1] == streaks[0] == [1, 2, 3]


def test_stale_streak_decays_on_preempt_less_cycles():
    envs = pair(setup=lambda env: blocked_setup(env, side=True))
    streaks = [[] for _ in envs]
    for k, env in enumerate(envs):
        pre = env.conv(preemptor())
        env.queues.add_or_update_workload(pre)
        env.scheduler.strict_after_blocked_cycles = 4
        for _ in range(3):
            env.cycle()
            env.queues.queue_inadmissible_workloads({"cq"})
            streaks[k].append(env.scheduler._blocked_preempt_streak)
        env.queues.delete_workload(pre)
        for n in range(7):
            env.submit(WorkloadWrapper(f"fit{n}").queue("lq-side")
                       .creation(10.0 + n).pod_set(count=1, cpu="1").obj())
            env.cycle()
            streaks[k].append(env.scheduler._blocked_preempt_streak)
    assert streaks[1] == streaks[0] == [1, 2, 3, 3, 3, 3, 3, 2, 1, 0]


def test_sparse_reattempts_still_reach_the_bound():
    envs = pair(setup=lambda env: blocked_setup(env, side=True))
    streaks = [[] for _ in envs]
    for k, env in enumerate(envs):
        env.submit(preemptor())
        env.scheduler.strict_after_blocked_cycles = 3
        n = 0
        for i in range(3):
            env.queues.queue_inadmissible_workloads({"cq"})
            env.cycle()
            streaks[k].append(env.scheduler._blocked_preempt_streak)
            if i == 2:
                break
            for _ in range(2):
                env.submit(WorkloadWrapper(f"fit{n}").queue("lq-side")
                           .creation(10.0 + n).pod_set(count=1, cpu="1")
                           .obj())
                env.cycle()
                n += 1
                streaks[k].append(env.scheduler._blocked_preempt_streak)
    assert streaks[1] == streaks[0]
    assert streaks[0][-1] >= 3


def test_deferred_plan_does_not_ratchet_the_streak():
    """tests/test_degrade.py test_shed_defers_preempt_planning: a plan the
    ladder defers looks blocked but does not feed the bound."""
    from kueue_tpu.resilience import degrade as jdegrade
    from kueue_tpu_torch.resilience import degrade as tdegrade
    envs = pair()
    out = []
    for env, degrade in zip(envs, (jdegrade, tdegrade)):
        env.add_flavor("default")
        env.add_cq(ClusterQueueWrapper("cq0")
                   .preemption(
                       within_cluster_queue=japi.PREEMPTION_LOWER_PRIORITY)
                   .resource_group(flavor_quotas("default", cpu="8")).obj(),
                   "lq-cq0")
        env.admit_existing(WorkloadWrapper("victim").queue("lq-cq0")
                           .priority(0).pod_set(count=1, cpu="8")
                           .reserve("cq0").obj())
        env.submit(WorkloadWrapper("pre").queue("lq-cq0").priority(10)
                   .creation(1.0).pod_set(count=1, cpu="8").obj())
        s = env.scheduler
        s.ladder = degrade.DegradationLadder(budget_s=1.0)
        s.ladder.state = degrade.SHED
        env.cycle()
        row = [bool(env.client.evicted), s.preempt_plans_deferred,
               s._blocked_preempt_streak]
        s.ladder.state = degrade.NORMAL
        env.cycle()
        row.append("default/victim" in env.client.evicted)
        out.append(row)
    assert out[1] == out[0] == [False, 1, 0, True]


def test_strict_bound_does_not_consume_the_probe():
    """tests/test_resilience.py:386: a cycle the strict gate takes off
    the device must not take the breaker's half-open probe."""
    from kueue_tpu.resilience import faultinject as jfi
    from kueue_tpu.resilience.breaker import CircuitBreaker as JBreaker
    from kueue_tpu_torch.resilience import faultinject as tfi
    from kueue_tpu_torch.resilience.breaker import CircuitBreaker as TBreaker
    envs = pair()
    rows = []
    for env, fi, breaker in zip(envs, (jfi, tfi), (JBreaker, TBreaker)):
        env.add_flavor("default")
        env.add_cq(ClusterQueueWrapper("cq").resource_group(
            flavor_quotas("default", cpu="100")).obj(), "lq")
        s = env.scheduler
        s.breaker = breaker(threshold=1, backoff_base_s=2.0, jitter=0.0)
        fi.install(fi.FaultInjector({fi.SITE_DISPATCH: {0: fi.RAISE}}))
        try:
            env.submit(WorkloadWrapper("w0").queue("lq").creation(0.0)
                       .pod_set(count=1, cpu="2").obj())
            env.cycle()
        finally:
            fi.uninstall()
        row = [s.breaker.state]
        env.clock.advance(10.0)
        s.strict_after_blocked_cycles = 2
        s._blocked_preempt_streak = 2
        env.submit(WorkloadWrapper("w1").queue("lq").creation(1.0)
                   .pod_set(count=1, cpu="2").obj())
        env.cycle()
        row += [s.cycle_counts.get("cpu-strict"), s.breaker.state]
        s._blocked_preempt_streak = 0
        env.submit(WorkloadWrapper("w2").queue("lq").creation(2.0)
                   .pod_set(count=1, cpu="2").obj())
        env.cycle()
        row += [s.breaker.state, s.breaker.recoveries]
        rows.append(row)
    assert rows[1] == rows[0] == ["open", 1, "open", "closed", 1]


# --- adaptive routing ---

def rate_script(regime, step):
    """(device progress, device secs, cpu progress, cpu secs) of a
    sample: a close race in the fit regime (the loser probed every 16),
    a hopeless CPU in the preempt regime (probed every 64), and the lead
    changing hands halfway."""
    if regime == "fit":
        dev, cpu = (10, 8) if step < 120 else (8, 10)
        return dev, 1.0, cpu, 1.0
    return 40, 1.0, 3, 1.0


@pytest.mark.parametrize("regime", ("fit", "preempt"))
def test_route_mode_from_equal_samples(regime):
    envs = pair()
    picks = [[] for _ in envs]
    from kueue_tpu.resilience.degrade import SHED as JSHED
    for k, env in enumerate(envs):
        s = env.scheduler
        s.solver_routing = "adaptive"
        s._last_regime = regime
        heads = [None] * 4
        for step in range(240):
            mode = s._route_mode(heads)
            picks[k].append(mode)
            dev_a, dev_t, cpu_a, cpu_t = rate_script(regime, step)
            s._cycle_regime = regime
            # a degraded cycle takes no sample (every 10th), nor does an
            # intervention route
            s._cycle_degraded = JSHED if step % 10 == 9 else "normal"
            s._route_record("cpu-strict", 99, 0.001)
            s._route_record(mode, dev_a if mode == "device" else cpu_a,
                            dev_t if mode == "device" else cpu_t)
        picks[k].append(sorted(s._route_stats.items()))
        picks[k].append(dict(s._route_explore))
    assert picks[1] == picks[0]
    modes = picks[0][:240]
    assert modes[:4] == ["device", "device", "cpu", "cpu"]
    assert "cpu" in modes[4:] and "device" in modes[4:]


def fixed_seconds(sched, secs):
    """Replace a sample's seconds by a fixed per-engine value: the route
    choice then depends on the progress alone, equal on both packages."""
    real = sched._route_record

    def record(mode, admitted, _secs):
        real(mode, admitted, secs.get(mode, 1.0))
    sched._route_record = record


def run_routed(setup, workloads, routing, cycles, fair_sharing=False,
               preempt="device"):
    envs = pair(preempt=preempt, fair_sharing=fair_sharing)
    for env in envs:
        env.scheduler.solver_routing = routing
        fixed_seconds(env.scheduler, {"device": 0.5, "cpu": 1.0})
        setup(env)
        for w in workloads():
            env.submit(w)
        for _ in range(cycles):
            env.cycle()
    ref, got = (observe(env, admissions_only=True) for env in envs)
    assert got == ref
    assert envs[1].scheduler.cycle_counts == envs[0].scheduler.cycle_counts
    assert envs[1].scheduler._route_stats == envs[0].scheduler._route_stats
    return envs


@pytest.mark.parametrize("routing", ("never", "adaptive"))
@pytest.mark.parametrize("seed", range(4))
def test_routing_fair_sharing(routing, seed):
    setup, workloads = fair_sharing_scenario(seed)
    envs = run_routed(setup, workloads, routing, cycles=4, fair_sharing=True,
                      preempt="cpu")
    if routing == "never":
        assert set(envs[0].scheduler.cycle_counts) == {"cpu-forced"}


@pytest.mark.parametrize("routing", ("never", "adaptive"))
@pytest.mark.parametrize("seed", PREEMPT_SEEDS[:4])
def test_routing_random_preemption(routing, seed):
    setup, workloads = random_preempt_scenario(seed)
    envs = run_routed(setup, workloads, routing, cycles=4)
    if routing == "adaptive":
        # the 2-sample start: device twice, then the CPU
        assert envs[0].scheduler.cycle_counts.get("device", 0) >= 1


# --- leader_check and cq_filter ---

@pytest.mark.parametrize("depth", (1, 2))
def test_leader_flip_abandons_in_flight_cycles(depth):
    p = Pipe(depth=depth)
    leader = {"on": True}
    for env in p.envs:
        env.scheduler.leader_check = lambda: leader["on"]
    p.submit_waves(1)
    p.cycle()
    p.submit_waves(1, start_wave=1)
    out = p.cycle()
    assert out["inflight"] >= 1
    applied = set(out["applied"])
    leader["on"] = False
    out = p.cycle()  # a non-leader: abandoned undecoded
    assert out["inflight"] == 0 and set(out["applied"]) == applied
    for env in p.envs:
        assert env.scheduler.solver._resident is None
        assert env.cache.live_handouts == 0
    leader["on"] = True
    out = p.settle()
    assert len(out["applied"]) == 2 * N_CQS
    # nothing admitted twice: one QuotaReserved event a workload
    for env in p.envs:
        assert set(quota_reserved_counts(env).values()) == {1}
    p.final()


def two_cq_setup(env):
    env.add_flavor("default")
    for name in ("cq-a", "cq-b"):
        env.add_cq(ClusterQueueWrapper(name).resource_group(
            flavor_quotas("default", cpu="10")).obj(), f"lq-{name}")


def test_cq_filter_pops_and_admits_only_its_cqs():
    envs = pair(setup=two_cq_setup)
    rows = []
    for env in envs:
        for i, lq in enumerate(("lq-cq-a", "lq-cq-b", "lq-cq-a", "lq-cq-b")):
            env.submit(WorkloadWrapper(f"w{i}").queue(lq).creation(float(i))
                       .pod_set(count=1, cpu="1").obj())
        heads = env.queues.heads_nonblocking(
            cq_filter=lambda name: name == "cq-a")
        row = [sorted(h.key for h in heads)]
        reason = importlib.import_module(f"{env.pkg}.queue").RequeueReason
        for h in heads:
            env.queues.requeue_workload(h, reason.GENERIC)
        env.scheduler.cq_filter = lambda name: name == "cq-b"
        env.cycle()
        env.cycle()
        row.append(sorted(env.client.applied))
        row.append(env.queues.pending("cq-a"))
        rows.append(row)
    assert rows[1] == rows[0]
    assert rows[0] == [["default/w0"], ["default/w1", "default/w3"], 2]
