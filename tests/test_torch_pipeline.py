"""The port's speculative pipeline against the JAX package's, cycle by
cycle.

Each scenario runs on both packages' Schedulers (tests/test_torch_scheduler
Env, the device route: the JAX BatchSolver on JAX-CPU, the port's with
device="cpu", its kernels' plain versions) with `pipeline_enabled`, the
same submissions, updates, completions and injected faults. After every
cycle the new events, the admissions (flavors, counts, conditions), the
evictions with their conditions, the requeues (status, reason, message),
`cycle_counts`, `speculation_hits`, `speculation_aborts` and
`speculation_abort_reasons` are equal, and `live_handouts` is 0 whenever
the pipeline is empty; at the end the usage per CQ and every other
observation of tests/test_torch_scheduler.py are equal. The cases are
tests/test_pipeline.py's (the stage contract, each clause of the
speculation token, the mis-speculation fallbacks, the randomized churn
against the synchronous oracle with injected mis-speculations, the shed
rung), depth 2 with a chained abort and with a collect fault that
flushes the chain, a pipelined mixed cycle (K9 riding the dispatch)
with and without a victim that completes during the lag, a whole-cycle
NoFit, each bail and closed gate, the router's fit bits against the JAX
router's on 120 seeded batches, and the two collect traps: a collect a
host gap after its dispatch raises no DispatchTimeout, and only
synchronous collects feed the watchdog's samples.
"""

import importlib
import random
import time

import numpy as np
import pytest

import kueue_tpu.solver.kernel  # noqa: F401  enables jax x64 before any array
from kueue_tpu.api import kueue as japi
from tests.test_solver import admitted_map
from tests.test_torch_scheduler import (
    PKGS,
    Env,
    _reset_features,  # noqa: F401  (autouse fixture)
    admission,
    conditions,
    observe,
)
from tests.wrappers import ClusterQueueWrapper, WorkloadWrapper, flavor_quotas

JAX, PORT = PKGS
N_CQS = 4


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    for pkg in PKGS:
        mod(pkg, "resilience.faultinject").uninstall()


def wl(name, i, priority=0, creation=0.0, cpu="2"):
    return (WorkloadWrapper(name).queue(f"lq-cq{i}").priority(priority)
            .creation(creation).pod_set(count=1, cpu=cpu).obj())


def four_cqs(cpu="8"):
    """tests/test_pipeline.py's cluster: four CQs in one cohort."""
    def setup(env):
        env.add_flavor("default")
        for i in range(N_CQS):
            env.add_cq(ClusterQueueWrapper(f"cq{i}").cohort("co")
                       .resource_group(flavor_quotas("default", cpu=cpu))
                       .obj(), f"lq-cq{i}")
    return setup


class Pipe:
    """Each package's pipelined Scheduler, driven alike; `cycle` runs one
    schedule() on both and asserts the observations equal."""

    def __init__(self, setup=four_cqs(), depth=1, fair_sharing=False,
                 preempt="device", pipeline=True):
        self.envs = [Env(pkg, "device", fair_sharing, preempt)
                     for pkg in PKGS]
        for env in self.envs:
            setup(env)
            s = env.scheduler
            s.pipeline_enabled = pipeline
            s.pipeline_depth = depth
        self.injectors = None
        self.seen = [0, 0]
        self.trace = []

    @property
    def port(self):
        return self.envs[1].scheduler

    def both(self, fn):
        return [fn(env) for env in self.envs]

    def each(self, fn):
        for env in self.envs:
            fn(env)

    def submit(self, w):
        self.each(lambda env: env.submit(w))

    def update(self, w):
        self.each(lambda env: env.queues.add_or_update_workload(env.conv(w)))

    def submit_waves(self, waves, start_wave=0, cpu="2"):
        n = start_wave * N_CQS
        for wave in range(start_wave, start_wave + waves):
            for i in range(N_CQS):
                self.submit(wl(f"w{wave}-{i}", i, creation=float(n), cpu=cpu))
                n += 1

    def install(self, schedule):
        self.injectors = [mod(pkg, "resilience.faultinject")
                          .FaultInjector(schedule) for pkg in PKGS]

    def advance(self, dt):
        self.each(lambda env: env.clock.advance(dt))

    def cycle(self) -> dict:
        got = []
        for i, env in enumerate(self.envs):
            fi = mod(env.pkg, "resilience.faultinject")
            s = env.scheduler
            if self.injectors is not None:
                fi.install(self.injectors[i])
            try:
                env.cycle()
            finally:
                fi.uninstall()
            events = env.client.events[self.seen[i]:]
            self.seen[i] = len(env.client.events)
            got.append(dict(
                events=events,
                applied={k: admission(w)
                         for k, w in env.client.applied.items()},
                evicted={k: conditions(w)
                         for k, w in env.client.evicted.items()},
                requeues=list(env.requeues),
                cycle_counts=dict(s.cycle_counts),
                hits=s.speculation_hits, aborts=s.speculation_aborts,
                reasons=dict(s.speculation_abort_reasons),
                inflight=len(s._inflight_q), faults=s.solver_faults,
                preempt_plan=s.last_preempt_plan,
                fired=(None if self.injectors is None
                       else dict(self.injectors[i].fired))))
            if not s._inflight_q:
                assert env.cache.live_handouts == 0, env.pkg
        assert got[0] == got[1], {k: (got[0][k], got[1][k])
                                  for k in got[0] if got[0][k] != got[1][k]}
        self.trace.append(got[1])
        return got[1]

    def run(self, cycles):
        for _ in range(cycles):
            self.cycle()
        return self.trace[-1]

    def settle(self, limit=12):
        """Cycles until the pipeline is empty and nothing is pending."""
        for _ in range(limit):
            self.cycle()
            s = self.port
            if not s._inflight_q and not self.envs[1].queues.pending_total():
                return self.trace[-1]
        raise AssertionError("did not settle")

    def final(self):
        ref, got = (observe(env) for env in self.envs)
        for k in ref:
            assert got[k] == ref[k], k
        return got


def quota_reserved_counts(env) -> dict:
    counts: dict = {}
    for key, reason, _msg in env.client.events:
        if reason == "QuotaReserved":
            counts[key] = counts.get(key, 0) + 1
    return counts


# --- tests/test_pipeline.py TestStageContract ---

def test_sync_cycle_through_typed_stages():
    """The synchronous cycle is nominate -> apply -> requeue with typed
    hand-offs, in both packages alike."""
    outs = []
    for pkg in PKGS:
        env = Env(pkg, "cpu")
        four_cqs()(env)
        for i in range(N_CQS):
            env.submit(wl(f"w0-{i}", i, creation=float(i)))
        stages = mod(pkg, "scheduler.stages")
        s = env.scheduler
        heads = env.queues.heads(timeout=0)
        snapshot = env.cache.snapshot()
        nom = s._stage_nominate(heads, snapshot, "cpu-forced", 0)
        assert isinstance(nom, stages.NominatedCycle)
        assert len(nom.entries) == N_CQS and nom.solver_entries == []
        s._stage_apply(nom, 0)
        applied = s._stage_requeue(nom)
        assert isinstance(applied, stages.AppliedCycle)
        outs.append((applied.admitted, applied.success,
                     sorted(env.client.applied)))
    assert outs[0] == outs[1] == (N_CQS, True, outs[0][2])
    assert len(outs[0][2]) == N_CQS


def test_inflight_cycle_is_typed_and_stamped():
    p = Pipe()
    p.submit_waves(2)
    out = p.cycle()  # dispatch-only
    assert out["cycle_counts"] == {"device-dispatch-only": 1}
    tokens = []
    for env in p.envs:
        stages = mod(env.pkg, "scheduler.stages")
        inflight = env.scheduler._inflight
        assert isinstance(inflight, stages.InFlightCycle)
        token = inflight.token
        assert isinstance(token, stages.SpeculationToken)
        assert token.epochs == env.cache.generation_token()
        assert token.resident is env.scheduler.solver._resident
        assert token.slots is not None and token.slot_gens is not None
        assert token.validate(env.cache, env.scheduler.solver) == (True, "")
        tokens.append((token.epochs, token.journal_seq,
                       np.asarray(token.slots).tolist(),
                       token.slot_gens.tolist(),
                       inflight.inflight.plan.fit_pred.tolist()))
    assert tokens[0] == tokens[1]
    out = p.settle()
    assert out["hits"] > 0 and out["aborts"] == 0
    p.final()


# --- TestSpeculationToken: each clause trips on its own, alike ---

def token_pipe():
    p = Pipe()
    p.submit_waves(2)
    p.cycle()
    return p, [env.scheduler._inflight.token for env in p.envs]


def validate_both(p, tokens):
    return [t.validate(env.cache, env.scheduler.solver)
            for t, env in zip(tokens, p.envs)]


def test_token_topology_epoch():
    p, tokens = token_pipe()
    p.each(lambda env: env.add_cq(
        ClusterQueueWrapper("late-cq").resource_group(
            flavor_quotas("default", cpu="8")).obj(), "lq-late"))
    assert validate_both(p, tokens) == [(False, "topology-epoch")] * 2


@pytest.mark.parametrize("pos,reason", ((1, "cohort-epoch"),
                                        (2, "flavor-spec-epoch")))
def test_token_cohort_and_flavor_spec_epochs(pos, reason):
    """Every structural edit moves the topology epoch too, so the cohort
    and flavor-spec clauses are tripped on a token whose epoch at that
    position lags the cache."""
    p, tokens = token_pipe()
    for t in tokens:
        e = list(t.epochs)
        e[pos] -= 1
        t.epochs = tuple(e)
    assert validate_both(p, tokens) == [(False, reason)] * 2


def test_token_residency():
    p, tokens = token_pipe()
    p.each(lambda env: env.scheduler.solver.invalidate_resident())
    assert validate_both(p, tokens) == [(False, "residency")] * 2


def test_token_arena_slots():
    p, tokens = token_pipe()
    victim = p.port._inflight.inflight.plan.batch.infos[0]
    # the Manager's upsert bumps the slot's generation before any
    # assemble drains it
    p.update(wl(victim.obj.metadata.name, 0, priority=3, creation=999.0))
    assert validate_both(p, tokens) == [(False, "arena-slots")] * 2


def test_token_journal_overflow():
    p, tokens = token_pipe()
    p.each(lambda env: env.cache._journal_overflowed.add("solver"))
    assert validate_both(p, tokens) == [(False, "journal-overflow")] * 2


def test_generations_current_is_the_cheap_check():
    got = []
    for pkg in PKGS:
        env = Env(pkg, "cpu")
        four_cqs()(env)
        gens = mod(pkg, "cache.incremental").generations_current
        snap = env.cache.snapshot()
        before = (gens(snap, env.cache), env.cache.snapshot_current(snap))
        env.add_flavor("late-flavor")
        got.append((before, gens(snap, env.cache),
                    env.cache.snapshot_current(snap)))
    assert got[0] == got[1] == ((True, True), False, False)


# --- TestMisSpeculationFallback ---

def test_topology_change_mid_flight_aborts_and_recovers():
    p = Pipe()
    p.submit_waves(3)
    p.cycle()
    p.each(lambda env: env.add_cq(
        ClusterQueueWrapper("late-cq").resource_group(
            flavor_quotas("default", cpu="8")).obj(), "lq-late"))
    out = p.cycle()
    assert out["aborts"] == 1 and out["reasons"] == {"topology-epoch": 1}
    p.run(8)
    for env in p.envs:
        assert len(admitted_map(env)) == 12
        assert set(quota_reserved_counts(env).values()) == {1}
    p.final()


def test_flavor_change_mid_flight_aborts():
    p = Pipe()
    p.submit_waves(3)
    p.cycle()
    p.each(lambda env: env.add_flavor("late"))
    out = p.cycle()
    assert out["reasons"] == {"topology-epoch": 1}
    out = p.run(8)
    assert out["hits"] >= 1
    p.final()


def test_inflight_update_aborts_and_readmits_fresh_object():
    p = Pipe()
    p.submit_waves(3)
    p.cycle()
    victim = p.port._inflight.inflight.plan.batch.infos[0]
    vname = victim.obj.metadata.name
    p.update(wl(vname, 0, priority=5, creation=500.0))
    out = p.cycle()
    assert out["aborts"] == 1 and out["reasons"] == {"arena-slots": 1}
    p.run(8)
    for env in p.envs:
        assert len(admitted_map(env)) == 12
        assert quota_reserved_counts(env)[f"default/{vname}"] == 1
        assert env.client.applied[f"default/{vname}"].spec.priority == 5
    p.final()


# --- TestRandomizedChurnEquivalence ---

def roomy(env):
    """All-fit sizing (6 waves x 2 cpu <= 16 a CQ): the admitted set is
    total, whatever the in-flight timing."""
    four_cqs(cpu="16")(env)


def churn_schedule(seed):
    rng = random.Random(seed)
    schedule = []
    for c in range(6):
        ups = []
        if c >= 1 and rng.random() < 0.7:
            wave = rng.randrange(0, c + 1)
            ups.append((f"w{wave}-{rng.randrange(N_CQS)}",
                        rng.randrange(1, 9)))
        schedule.append((True, ups))
    schedule += [(False, [])] * 8
    return schedule, sorted(rng.sample(range(8), 2))


def churn_run(p, schedule):
    n = 0
    for c, (submit, ups) in enumerate(schedule):
        if submit:
            p.submit_waves(1, start_wave=c)
        for name, prio in ups:
            i = int(name.split("-")[1])
            p.update(wl(name, i, priority=prio, creation=1000.0 + n))
            n += 1
        p.cycle()
        p.advance(1.0)
    for _ in range(10):
        p.cycle()
        p.advance(1.0)
        if not p.port._inflight_q \
                and not p.envs[1].queues.pending_total():
            break


@pytest.mark.parametrize("seed", [3, 17, 404])
def test_random_churn_matches_jax_and_the_sync_oracle(seed):
    schedule, inject_hits = churn_schedule(seed)
    p = Pipe(roomy)
    p.install({"speculation_validate": {h: "raise" for h in inject_hits}})
    churn_run(p, schedule)
    assert p.port.speculation_abort_reasons.get("injected")
    oracle = Pipe(roomy, pipeline=False)
    churn_run(oracle, schedule)
    assert not oracle.port.speculation_hits
    for env, ref in zip(p.envs, oracle.envs):
        assert set(admitted_map(env)) == set(admitted_map(ref))
        for i in range(N_CQS):
            assert env.cache.usage_for_cluster_queue(f"cq{i}") \
                == ref.cache.usage_for_cluster_queue(f"cq{i}")
        assert set(quota_reserved_counts(env).values()) == {1}
    p.final()


# --- TestShedRungPipelining ---

def set_shed(p, **kwargs):
    for env in p.envs:
        degrade = mod(env.pkg, "resilience.degrade")
        s = env.scheduler
        s.ladder = degrade.DegradationLadder(budget_s=60.0, escalate_after=1,
                                             recovery_cycles=99,
                                             ewma_alpha=1.0, **kwargs)
        s.ladder.state = degrade.SHED


def test_pipeline_survives_shed_rung_with_head_cap():
    p = Pipe()
    set_shed(p, shed_heads=2)
    p.submit_waves(2)
    out = p.run(10)
    assert out["cycle_counts"].get("device-pipelined", 0) > 0
    assert p.port.shed_heads_requeued > 0
    assert len(admitted_map(p.envs[1])) == 8 and out["aborts"] == 0
    p.final()


def lower_priority_cqs(n=2, cpu="4"):
    def setup(env):
        env.add_flavor("default")
        for i in range(n):
            env.add_cq(ClusterQueueWrapper(f"cq{i}")
                       .preemption(
                           within_cluster_queue=japi.PREEMPTION_LOWER_PRIORITY)
                       .resource_group(flavor_quotas("default", cpu=cpu))
                       .obj(), f"lq-cq{i}")
    return setup


def victims_and_preemptors(p, n=2):
    for i in range(n):
        p.each(lambda env, i=i: env.admit_existing(
            WorkloadWrapper(f"victim{i}").queue(f"lq-cq{i}").priority(0)
            .pod_set(count=1, cpu="4").reserve(f"cq{i}").obj()))
        p.submit(WorkloadWrapper(f"preemptor{i}").queue(f"lq-cq{i}")
                 .priority(10).creation(float(i)).pod_set(count=1, cpu="4")
                 .obj())


def test_preempt_needing_cycle_bails_to_sync_under_shed():
    p = Pipe(lower_priority_cqs())
    set_shed(p, shed_heads=8)
    victims_and_preemptors(p)
    out = p.run(4)
    assert "pipelined-preempt" not in out["cycle_counts"]
    assert p.port.preempt_plans_deferred > 0
    assert not out["evicted"]
    p.final()


# --- depth 2 ---

def test_depth_two_chained_abort():
    """Two cycles in flight; an injected mis-speculation on the younger
    one drains the older first, aborts the younger, and the aborts
    chain through the queue."""
    p = Pipe(roomy, depth=2)
    p.submit_waves(6)
    p.install({"speculation_validate": {2: "raise"}})
    out = p.settle()
    assert out["cycle_counts"].get("device-dispatch-only", 0) >= 2
    assert out["reasons"].get("injected") == 1
    for env in p.envs:
        assert len(admitted_map(env)) == 24
        assert set(quota_reserved_counts(env).values()) == {1}
    p.final()


def test_depth_two_abort_chains_the_younger_cycle():
    """A topology change with two cycles in flight: the older one fails
    first and the younger is flushed as a "chained" abort."""
    p = Pipe(roomy, depth=2)
    p.submit_waves(6)
    p.run(2)
    assert p.trace[-1]["inflight"] == 2
    p.each(lambda env: env.add_flavor("late"))
    out = p.cycle()
    assert out["reasons"] == {"topology-epoch": 1, "chained": 1}
    assert out["aborts"] == 2
    p.settle()
    for env in p.envs:
        assert len(admitted_map(env)) == 24
    p.final()


def test_depth_two_collect_fault_flushes_the_chain():
    p = Pipe(roomy, depth=2)
    p.submit_waves(6)
    p.install({"device_collect": {0: "raise"}})
    out = p.settle()
    assert out["faults"] == 1 and out["aborts"] == 0
    for env in p.envs:
        assert len(admitted_map(env)) == 24
        assert set(quota_reserved_counts(env).values()) == {1}
    p.final()


def test_depth_collapses_to_one_without_a_token():
    """A token-less in-flight cycle collapses the effective depth to 1."""
    p = Pipe(roomy, depth=2)
    p.submit_waves(4)
    p.cycle()
    for env in p.envs:
        env.scheduler._inflight_q[0].token = None
    out = p.cycle()
    assert out["inflight"] == 1 and out["hits"] == 0
    assert out["cycle_counts"].get("device-pipelined") == 1
    p.settle()
    p.final()


# --- the pipelined mixed cycle ---

def mixed_setup(env):
    """Six roomy Never/Never CQs and one LowerPriority CQ held by a
    priority-0 victim."""
    env.add_flavor("default")
    for i in range(6):
        env.add_cq(ClusterQueueWrapper(f"cq{i}")
                   .resource_group(flavor_quotas("default", cpu="16"))
                   .obj(), f"lq-cq{i}")
    env.add_cq(ClusterQueueWrapper("cq6")
               .preemption(within_cluster_queue=japi.PREEMPTION_LOWER_PRIORITY)
               .resource_group(flavor_quotas("default", cpu="4")).obj(),
               "lq-cq6")
    env.admit_existing(WorkloadWrapper("victim").queue("lq-cq6").priority(0)
                       .pod_set(count=1, cpu="4").reserve("cq6").obj())


def mixed_pipe():
    p = Pipe(mixed_setup)
    for wave in range(3):
        for i in range(6):
            p.submit(wl(f"w{wave}-{i}", i, creation=float(wave * 10 + i)))
    p.submit(WorkloadWrapper("preemptor").queue("lq-cq6").priority(10)
             .creation(50.0).pod_set(count=1, cpu="4").obj())
    return p


def test_pipelined_mixed_cycle_issues_evictions_at_collect():
    p = mixed_pipe()
    out = p.cycle()  # the preemptor rides the dispatch as a K9 batch
    assert out["cycle_counts"] == {"device-dispatch-only": 1}
    assert p.port._inflight.pmeta is not None
    assert p.port._inflight.inflight.preempt_batch is not None
    out = p.cycle()
    assert out["cycle_counts"].get("pipelined-preempt") == 1
    assert set(out["evicted"]) == {"default/victim"}
    assert out["preempt_plan"]["minimal"]["problems"] == 1
    p.each(lambda env: env.cache.delete_workload(
        env.client.evicted["default/victim"]))
    out = p.settle()
    assert "default/preemptor" in out["applied"]
    p.final()


def test_pipelined_mixed_cycle_victim_completes_during_the_lag():
    """The victim finishes between the dispatch that chose it and the
    collect: no eviction is issued, the preemptor is requeued and admits
    into the freed quota."""
    p = mixed_pipe()
    p.cycle()
    p.each(lambda env: env.cache.delete_workload(env.conv(
        WorkloadWrapper("victim").queue("lq-cq6").priority(0)
        .pod_set(count=1, cpu="4").reserve("cq6").obj())))
    out = p.cycle()
    assert out["cycle_counts"].get("pipelined-preempt") == 1
    assert not out["evicted"]
    out = p.settle()
    assert "default/preemptor" in out["applied"] and not out["evicted"]
    p.final()


def test_pend_rows_over_a_quarter_bail():
    """Two preempt rows of four heads: the synchronous path owns the
    cycle (and cools the next one down)."""
    p = Pipe(lower_priority_cqs(n=2))
    victims_and_preemptors(p, n=2)
    out = p.cycle()
    assert out["cycle_counts"] == {"device": 1}
    assert out["evicted"]
    p.run(3)
    p.final()


# --- a whole-cycle NoFit ---

def test_whole_cycle_nofit_dispatches_nothing():
    def setup(env):
        four_cqs(cpu="2")(env)
        for i in range(N_CQS):
            env.admit_existing(WorkloadWrapper(f"old{i}").queue(f"lq-cq{i}")
                               .pod_set(count=1, cpu="2").reserve(f"cq{i}")
                               .obj())
    p = Pipe(setup)
    p.submit_waves(1)
    dispatches = p.port.solver.counters["dispatches"]
    out = p.cycle()
    assert out["cycle_counts"] == {"device-nofit": 1}
    assert p.port.solver.counters["dispatches"] == dispatches
    assert len(out["requeues"]) == N_CQS
    p.final()


def test_nofit_cycle_drains_the_flight():
    """A whole-cycle NoFit with a cycle in flight collects it. Four
    cohortless CQs of 2 cpu, three of them full: the first cycle
    dispatches cq0's head (the others take the NoFit shortcut), the
    second's heads are all NoFit."""
    def setup(env):
        env.add_flavor("default")
        for i in range(N_CQS):
            env.add_cq(ClusterQueueWrapper(f"cq{i}").resource_group(
                flavor_quotas("default", cpu="2")).obj(), f"lq-cq{i}")
            if i:
                env.admit_existing(
                    WorkloadWrapper(f"old{i}").queue(f"lq-cq{i}")
                    .pod_set(count=1, cpu="2").reserve(f"cq{i}").obj())
    p = Pipe(setup)
    p.submit_waves(1)
    out = p.cycle()
    assert out["cycle_counts"] == {"device-dispatch-only": 1}
    for i in range(1, N_CQS):
        p.submit(wl(f"x{i}", i, creation=10.0 + i))
    out = p.cycle()
    assert out["cycle_counts"].get("device-nofit") == 1
    assert out["hits"] == 1 and set(out["applied"]) == {"default/w0-0"}
    p.final()


# --- the bails and the closed gate ---

def test_fair_sharing_preempt_row_bails():
    def setup(env):
        lower_priority_cqs(n=4)(env)
    p = Pipe(setup, fair_sharing=True)
    victims_and_preemptors(p, n=1)
    for i in range(1, 4):
        p.submit(wl(f"w{i}", i, creation=float(i), cpu="1"))
    out = p.cycle()
    assert out["cycle_counts"] == {"device": 1}
    assert p.port._pipeline_cooldown == 1
    p.run(3)
    p.final()


def test_fair_sharing_all_fit_cycles_pipeline():
    p = Pipe(roomy, fair_sharing=True)
    p.submit_waves(3)
    out = p.settle()
    assert out["hits"] >= 2
    p.final()


def test_partial_admission_row_bails():
    def setup(env):
        four_cqs(cpu="4")(env)
    p = Pipe(setup)
    for i in range(N_CQS):
        p.submit(wl(f"w{i}", i, creation=float(i)))
    # 20 cpu: more than the cohort's 16, so the router predicts no fit
    p.submit(WorkloadWrapper("elastic").queue("lq-cq0").creation(10.0)
             .pod_set(count=10, min_count=1, cpu="2").obj())
    p.cycle()
    out = p.cycle()
    # the bail drains the flight, then the synchronous path reduces it
    assert out["cycle_counts"] == {"device-dispatch-only": 1,
                                   "device-pipelined": 1, "device": 1}
    assert out["hits"] == 1 and "default/elastic" in out["applied"]
    assert out["applied"]["default/elastic"][1][0][3] < 10  # reduced
    p.run(2)
    p.final()


def test_strict_fifo_closes_the_gate():
    def setup(env):
        env.add_flavor("default")
        for i in range(N_CQS):
            w = ClusterQueueWrapper(f"cq{i}").cohort("co")
            if i == 0:
                w = w.queueing_strategy(japi.STRICT_FIFO)
            env.add_cq(w.resource_group(flavor_quotas("default", cpu="8"))
                       .obj(), f"lq-cq{i}")
    p = Pipe(setup)
    assert p.both(lambda env: env.queues.any_strict_fifo()) == [True, True]
    p.submit_waves(2)
    out = p.run(3)
    assert set(out["cycle_counts"]) == {"device"} and out["hits"] == 0
    p.final()


def test_pods_ready_tracking_closes_the_gate():
    p = Pipe()
    p.each(lambda env: setattr(env.cache, "pods_ready_tracking", True))
    p.submit_waves(1)
    out = p.run(2)
    assert set(out["cycle_counts"]) == {"device"}
    p.final()


def test_half_open_breaker_runs_the_probe_synchronously():
    p = Pipe()
    for env in p.envs:
        b = mod(env.pkg, "resilience.breaker").CircuitBreaker(
            threshold=1, backoff_base_s=1.0, jitter=0.0)
        b.record_fault(env.clock.now())
        env.scheduler.breaker = b
    p.submit_waves(1)
    out = p.cycle()
    assert out["cycle_counts"] == {"cpu-breaker": 1}
    p.advance(2.0)
    p.submit_waves(1, start_wave=1)
    out = p.cycle()
    assert out["cycle_counts"] == {"cpu-breaker": 1, "device": 1}
    assert p.both(lambda env: env.scheduler.breaker.state) \
        == ["closed", "closed"]
    p.submit_waves(1, start_wave=2)
    out = p.cycle()
    assert out["cycle_counts"].get("device-dispatch-only") == 1
    p.settle()
    p.final()


def test_survival_pins_the_cpu_and_drains_the_flight():
    p = Pipe()
    p.submit_waves(2)
    p.cycle()
    for env in p.envs:
        degrade = mod(env.pkg, "resilience.degrade")
        env.scheduler.ladder = degrade.DegradationLadder(
            budget_s=60.0, survival_heads=8, recovery_cycles=99)
        env.scheduler.ladder.state = degrade.SURVIVAL
    out = p.cycle()
    assert out["cycle_counts"].get("cpu-survival") == 1
    assert out["hits"] == 1 and out["inflight"] == 0
    p.final()


def test_pipeline_disabled_mid_flight_drains():
    p = Pipe()
    p.submit_waves(2)
    p.cycle()
    for env in p.envs:
        env.scheduler.pipeline_enabled = False
    out = p.cycle()
    assert out["hits"] == 1 and out["inflight"] == 0
    assert out["cycle_counts"].get("device") == 1
    p.final()


def test_abandon_pipeline_requeues_and_drops_residency():
    p = Pipe()
    p.submit_waves(2)
    p.cycle()
    for env in p.envs:
        env.scheduler._abandon_pipeline()
        assert env.scheduler.solver._resident is None
        assert env.cache.live_handouts == 0
    out = p.settle()
    assert len(out["applied"]) == 8
    p.final()


def test_headless_drain():
    p = Pipe()
    p.submit_waves(1)
    p.cycle()
    out = p.cycle()  # no heads: the in-flight cycle drains
    assert out["hits"] == 1 and len(out["applied"]) == N_CQS
    assert out["inflight"] == 0
    p.final()


# --- the router: Plan.fit_pred against the JAX package's _route ---

def route_scenario(seed: int):
    """F flavors (1-4), nested cohorts (or a flat one), CQs of varied
    quotas and borrowing limits, admitted workloads, pending heads."""
    rng = random.Random(9100 + seed)
    F = rng.randint(1, 4)
    flavors = [f"f{k}" for k in range(F)]
    deep = rng.random() < 0.6
    cqs = []
    for i in range(rng.randint(3, 7)):
        cohort = (rng.choice(["root", "left", "right"]) if deep
                  else rng.choice(["co", ""]))
        quotas = [(f, str(rng.choice([2, 4, 6, 8]))) for f in flavors
                  if rng.random() < 0.85] or [(flavors[0], "4")]
        cqs.append((f"cq{i}", cohort, quotas))
    existing = [(f"old{j}", rng.randrange(len(cqs)),
                 str(rng.choice([1, 2, 3]))) for j in range(rng.randint(0, 8))]
    heads = [(f"w{j}", rng.randrange(len(cqs)),
              str(rng.choice([1, 2, 3, 5, 9])), rng.randint(0, 4))
             for j in range(rng.randint(4, 12))]

    def setup(env):
        for f in flavors:
            env.add_flavor(f)
        if deep:
            env.add_cohort("root")
            env.add_cohort("left", "root")
            env.add_cohort("right", "root")
        for name, cohort, quotas in cqs:
            w = ClusterQueueWrapper(name)
            if cohort:
                w = w.cohort(cohort)
            env.add_cq(w.resource_group(*(flavor_quotas(f, cpu=q)
                                          for f, q in quotas)).obj(),
                       f"lq-{name}")
        for n, ci, c in existing:
            name, _cohort, quotas = cqs[ci]
            env.admit_existing(WorkloadWrapper(n).queue(f"lq-{name}")
                               .pod_set(count=1, cpu=c)
                               .reserve(name, flavor=quotas[0][0]).obj())
    return setup, heads


@pytest.mark.parametrize("chunk", range(4))
def test_router_bits_equal_jax(chunk):
    """Plan.fit_pred (prepare(..., route=True)) equals the JAX solver's
    _route bits on 30 seeded scenarios a chunk (seeds chunk, chunk + 4,
    ...; 120 in all, each routed twice: its first batch, then, after a
    synchronous cycle, the heads it requeued, whose resume ranks ride
    along in some of each chunk's scenarios)."""
    with_rank = 0
    for seed in range(chunk, 120, 4):
        setup, heads = route_scenario(seed)
        envs = [Env(pkg, "device") for pkg in PKGS]
        for env in envs:
            setup(env)
            for name, ci, c, prio in heads:
                env.submit(WorkloadWrapper(name).queue(f"lq-cq{ci}")
                           .priority(prio).pod_set(count=1, cpu=c).obj())
        for rnd in range(2):
            bits, ranks = [], []
            for env in envs:
                s = env.scheduler
                hs = env.queues.heads(timeout=0)
                snap = env.cache.snapshot()
                if env.pkg == PORT:
                    plan = s.solver.prepare(snap, hs, route=True)
                else:
                    plan = s.solver.prepare(snap, hs)
                env.cache.release_snapshot(snap)
                bits.append(None if plan is None else plan.fit_pred.tolist())
                ranks.append(None if plan is None or plan.start_rank is None
                             else plan.start_rank.tolist())
                for w in hs:
                    env.queues.requeue_workload(
                        w, mod(env.pkg, "queue").RequeueReason.GENERIC)
                s.solver.invalidate_resident()
            assert bits[0] == bits[1], (seed, rnd)
            assert ranks[0] == ranks[1], (seed, rnd)
            with_rank += ranks[1] is not None
            if rnd == 0:
                for env in envs:
                    env.queues.queue_inadmissible_workloads(
                        set(env.cq_names))
                    env.cycle()
                    env.queues.queue_inadmissible_workloads(
                        set(env.cq_names))
    assert with_rank > 0


# --- the collect traps ---

def trap_pipe(deadline_s):
    p = Pipe()
    for env in p.envs:
        s = env.scheduler
        s.watchdog = mod(env.pkg, "resilience.watchdog").DispatchWatchdog(
            safety_factor=1.0, min_deadline_s=deadline_s,
            max_deadline_s=deadline_s)
        s.solver.supervise_dispatch = False
    return p


def test_collect_after_a_host_gap_raises_no_timeout():
    """A pipelined collect comes a host cycle after its dispatch: a
    result that landed long before raises no DispatchTimeout, however
    far the gap exceeds the deadline (a collect deadline counted from
    the dispatch would raise here)."""
    p = trap_pipe(0.05)
    p.submit_waves(3)
    p.cycle()
    for _ in range(2):
        time.sleep(0.2)
        out = p.cycle()
        assert out["faults"] == 0
    assert out["hits"] == 2 and out["aborts"] == 0
    assert p.both(lambda env: env.scheduler.solver.counters[
        "dispatch_timeouts"]) == [0, 0]
    p.final()


def test_collect_delay_past_the_deadline_still_times_out():
    """Collect's own time (an injected delay) past the deadline is a
    DispatchTimeout on the pipelined path too: a collect fault."""
    p = trap_pipe(0.05)
    p.submit_waves(3)
    p.cycle()
    p.install({"device_collect": {0: ("delay", 0.2)}})
    out = p.cycle()
    assert out["faults"] == 1
    assert p.both(lambda env: env.scheduler.solver.counters[
        "dispatch_timeouts"]) == [1, 1]
    p.injectors = None
    p.settle()
    p.final()


def test_only_synchronous_collects_feed_the_watchdog():
    p = Pipe()
    p.submit_waves(4)
    p.cycle()
    p.cycle()
    p.cycle()
    assert p.trace[-1]["hits"] == 2
    assert p.both(lambda env: len(env.scheduler.solver._sync_samples)) \
        == [0, 0]
    for env in p.envs:
        env.scheduler.pipeline_enabled = False
    p.cycle()  # drains the flight, then a synchronous cycle
    n = p.both(lambda env: len(env.scheduler.solver._sync_samples))
    assert n[1] >= 1 and n[0] >= 1
    p.final()
