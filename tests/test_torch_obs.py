"""The port's observability plane against the JAX package's: the flight
recorder's traces, the metrics registry, the journey ledger and the aging
watch, wired onto each package's Scheduler as kueue_tpu/manager.py wires
them (tests/test_torch_scheduler.py's Env, the JAX package on JAX-CPU
with x64, the port on the CPU with its kernels' plain versions), plus
the JAX package's own unit cases of the ledger and the watch
(tests/test_obs.py TestJourneyLedger, TestAgingWatch) as direct drives
of the port's classes.

After every cycle of the fit, preempt, partial-admission, fault-injected
(FaultInjector.scripted) and pipelined depth-1 scenarios, each trace's
route, regime, heads, admitted, evictions, faults, breaker and degraded
rung are equal, so are its annotations (kinds and fields, in order; not
the messages, which quote exception reprs) and its span names, and at
the end every counter and gauge series of the two registries, every
histogram series' count (and sum where the values come from the fake
clock) and every journey (journey_dict; the clocks are fake, so even the
times compare). Exclusions, by design of the port, each named in
`trace_row` and `compare_registries`:

- span times and byte counts (upload_bytes, fetch_bytes);
- the port's own spans, dotted under a JAX phase (PORT_ONLY_SPANS);
- on a synchronous device cycle the JAX Scheduler runs its fit router
  ("route") before the sync and nominates the heads it predicts will
  not fit before its dispatch; the port runs no router there and
  nominates them after the collect: the span names compare as a
  multiset without "route", and a cycle whose solve faulted (the port
  returns every head to nomination at once) compares the port's names
  as a subset of the JAX ones; its "compile" annotations name the
  programs the cycle ran, which differ with it, and are left out;
- dispatches and collects where the JAX Scheduler makes no trip (no
  head fits and nothing preempts on the device) and the port dispatches
  all the same (the port reads the non-fit heads from the device);
- cycle_phase_seconds series of the device route (their phases follow
  the spans above); each package's histograms are held against its own
  traces' phase_sums instead.
"""

import importlib
import math

import pytest

import kueue_tpu.solver.kernel  # noqa: F401  enables jax x64 before any array
from tests.test_torch_pipeline import Pipe, four_cqs
from tests.test_torch_scheduler import (
    PKGS,
    Env,
    random_preempt_scenario,
    simple_setup,
)
from tests.wrappers import WorkloadWrapper

JAX, PORT = PKGS

PORT_ONLY_SPANS = frozenset({
    "fetch.device", "preempt-plan.solve", "preempt-plan.decode",
    "apply.device", "nominate.partial", "nominate.partial-assign",
    "dispatch.plan"})

# annotation fields that carry times
TIME_FIELDS = ("message", "ewma_ms", "budget_ms", "ms")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    # each test starts from empty program registries (process-wide on
    # both packages), so that "compile" annotations compare
    for pkg in PKGS:
        mod(pkg, "solver.service").reset_seen_programs()
    yield
    for pkg in PKGS:
        mod(pkg, "resilience.faultinject").uninstall()


def attach(env, objectives=None):
    """The manager's wiring (kueue_tpu/manager.py:132-300): a Registry,
    a JourneyLedger on the Manager's journey listener, an AgingWatch
    sampled at every seal."""
    obs = mod(env.pkg, "obs")
    s = env.scheduler
    s.metrics = mod(env.pkg, "metrics").Registry()
    led = obs.JourneyLedger(metrics=s.metrics, clock=env.clock,
                            generation_source=env.cache.generation_token)
    if objectives:
        led.set_objectives(objectives)
    env.queues.add_journey_listener(led.note_queue_delta)
    s.journeys = led
    watch = obs.AgingWatch()
    watch.add("live_handouts", lambda: env.cache.live_handouts,
              slope_threshold=0.05)
    watch.add("requeue_amplification", lambda: led.requeues_per_admission,
              slope_threshold=0.02, window=32)
    watch.add("mid_traffic_compiles",
              lambda: s.solver.counters.get("mid_traffic_compiles", 0),
              slope_threshold=0.01, window=16)
    s.aging = watch
    return env


def trace_row(t) -> dict:
    names = [n for n, _s, _d in t.spans if n not in PORT_ONLY_SPANS]
    row = dict(route=t.route, regime=t.regime, heads=t.heads,
               admitted=t.admitted, evictions=t.evictions, faults=t.faults,
               breaker=t.breaker, degraded=t.degraded,
               annotations=[{k: v for k, v in a.items()
                             if k not in TIME_FIELDS}
                            for a in t.annotations],
               spans=names, trips=(t.dispatches, t.collects))
    return row


def compare_traces(jt, pt) -> None:
    j, p = trace_row(jt), trace_row(pt)
    jspans, pspans = j.pop("spans"), p.pop("spans")
    jtrips, ptrips = j.pop("trips"), p.pop("trips")
    if jt.route == "device":
        # the programs of a synchronous device cycle differ (no router,
        # K9/K11 launched apart): its "compile" annotations too
        for row in (j, p):
            row["annotations"] = [a for a in row["annotations"]
                                  if a["kind"] != "compile"]
    assert p == j
    if jt.route == "device":
        jtop = sorted(n for n in jspans if n != "route")
        ptop = sorted(pspans)
        if not jtrips[0]:
            # the JAX Scheduler made no trip; the port's are left out
            ptop = [n for n in ptop
                    if n.split(".")[0] not in ("dispatch", "fetch",
                                               "decode")]
        if jt.faults:
            assert set(ptop) <= set(jtop), (ptop, jtop)
        else:
            assert ptop == jtop, (ptop, jtop)
        if jtrips[0]:
            assert ptrips == jtrips
    else:
        assert pspans == jspans
        assert ptrips == jtrips


def compare_registries(jreg, preg) -> None:
    jall = {m.name: m for m in jreg._all}
    pall = {m.name: m for m in preg._all}
    assert set(pall) == set(jall)
    for name, jm in jall.items():
        pm = pall[name]
        assert type(pm).__name__ == type(jm).__name__, name
        assert pm.label_names == jm.label_names, name
        if hasattr(jm, "values"):
            assert pm.values == jm.values, name
            continue
        assert pm.buckets == jm.buckets, name
        for key in set(jm.series) | set(pm.series):
            phase_hist = name.endswith("cycle_phase_seconds")
            if phase_hist and key[jm.label_names.index("route")] == "device":
                continue
            js, ps = jm.series.get(key), pm.series.get(key)
            assert (ps is None) == (js is None), (name, key)
            assert ps[2] == js[2], (name, key)
            if not phase_hist and ("wait_time" in name
                                   or name.endswith("cycle_heads")):
                assert ps[1] == js[1], (name, key)
                assert ps[0] == js[0], (name, key)


def phase_sums_reconcile(sched) -> None:
    """cycle_phase_seconds == the sum of the traces' phase_sums, per
    phase (tests/test_obs.py:149-167), and the solver's cumulative
    phase_s == its spans' totals (tests/test_obs.py:212-227)."""
    traces = sched.recorder.traces()
    want: dict = {}
    for t in traces:
        for phase, secs in t.phase_sums().items():
            want[phase] = want.get(phase, 0.0) + secs
    h = sched.metrics.cycle_phase_seconds
    pi = h.label_names.index("phase")
    got: dict = {}
    for key, (_counts, total, _n) in h.series.items():
        got[key[pi]] = got.get(key[pi], 0.0) + total
    assert set(got) == set(want)
    for phase, secs in want.items():
        assert got[phase] == pytest.approx(secs, rel=1e-9)
    if sched.solver is not None and sched.recorder.cycles_recorded \
            == len(traces):
        for phase in ("encode", "dispatch", "fetch", "decode"):
            total = sum(d for t in traces for n, _s, d in t.spans
                        if n == phase)
            assert total == pytest.approx(sched.solver.phase_s[phase],
                                          rel=1e-9, abs=1e-12)


def journey_keys(env) -> set:
    keys = set(env.client.applied) | set(env.client.evicted)
    for items in env.queues.local_queues.values():
        keys |= set(items.items)
    return keys


def compare_journeys(envs) -> None:
    jl, pl = (env.scheduler.journeys for env in envs)
    keys = journey_keys(envs[0])
    assert journey_keys(envs[1]) == keys
    for key in sorted(keys):
        assert pl.journey_dict(key) == jl.journey_dict(key), key
    assert pl.requeues_per_admission == jl.requeues_per_admission
    assert [j.to_dict() for j in pl.slowest()] \
        == [j.to_dict() for j in jl.slowest()]
    assert [j.to_dict() for j in pl.violations()] \
        == [j.to_dict() for j in jl.violations()]
    assert pl.burn_rates() == jl.burn_rates()
    assert pl.status() == jl.status()


def check_pair(envs, seen) -> None:
    """The traces sealed since the last check, pairwise."""
    jtr, ptr = (env.scheduler.recorder.traces() for env in envs)
    assert len(ptr) == len(jtr)
    for jt, pt in zip(jtr[seen[0]:], ptr[seen[0]:]):
        compare_traces(jt, pt)
    seen[0] = len(jtr)


def finish(envs) -> None:
    compare_registries(*(env.scheduler.metrics for env in envs))
    for env in envs:
        phase_sums_reconcile(env.scheduler)
        assert env.scheduler.aging.gate()["ok"], env.scheduler.aging.status()
    compare_journeys(envs)
    assert envs[1].scheduler.aging.verdicts() \
        == envs[0].scheduler.aging.verdicts()
    for env in envs:
        # every admission sealed a journey; the retained ones are whole
        led = env.scheduler.journeys
        reserved = sum(1 for _k, reason, _m in env.client.events
                       if reason == "QuotaReserved")
        assert led.journeys_completed == reserved
        for j in led.slowest():
            assert j.timeline_complete()[0], j.to_dict()


def observed_pair(route="device", preempt="device", objectives=None, **kw):
    return [attach(Env(pkg, route, preempt=preempt, **kw), objectives)
            for pkg in PKGS]


def wave(envs, n, start, cq_count=4, cpu="2"):
    for env in envs:
        for i in range(n):
            k = start + i
            env.submit(WorkloadWrapper(f"w{k}").queue(f"lq-cq{k % cq_count}")
                       .creation(float(k)).pod_set(count=1, cpu=cpu).obj())


def finish_some(envs, keys):
    for env in envs:
        for key in keys:
            wl = env.client.applied.get(key)
            if wl is not None:
                env.cache.delete_workload(wl)
        env.queues.queue_inadmissible_workloads(set(env.cq_names))


@pytest.mark.parametrize("route", ("device", "cpu"))
def test_fit_scenario_traces_metrics_journeys(route):
    envs = observed_pair(route, objectives={"standard": 2.0})
    for env in envs:
        four_cqs("4")(env)
    seen = [0]
    for c in range(6):
        wave(envs, 6, 6 * c)
        for env in envs:
            env.clock.advance(1.5)
            env.cycle()
        check_pair(envs, seen)
        finish_some(envs, [f"default/w{6 * c + i}" for i in range(0, 6, 2)])
    finish(envs)
    # the objective priced the seals: some waited past it
    assert envs[1].scheduler.journeys.violations()
    assert envs[1].scheduler.journeys.burn_rates()["standard"] > 0


@pytest.mark.parametrize("seed", (4, 5, 10))
def test_preempt_scenario(seed):
    setup, workloads = random_preempt_scenario(seed)
    envs = observed_pair()
    seen = [0]
    for env in envs:
        setup(env)
        for w in workloads():
            env.submit(w)
    for _ in range(3):
        for env in envs:
            env.clock.advance(1.0)
            env.cycle()
        check_pair(envs, seen)
    finish(envs)
    assert any(t.evictions for t in envs[0].scheduler.recorder.traces()) \
        or seed != 4


def test_partial_admission_scenario():
    envs = observed_pair()
    seen = [0]
    for env in envs:
        simple_setup("6")(env)
        env.submit(WorkloadWrapper("w").queue("lq")
                   .pod_set(count=10, min_count=2, cpu="1").obj())
        env.submit(WorkloadWrapper("x").queue("lq").priority(-1)
                   .pod_set(count=3, min_count=1, cpu="4").obj())
    for _ in range(2):
        for env in envs:
            env.cycle()
        check_pair(envs, seen)
    finish(envs)


@pytest.mark.parametrize("seed", (1, 3))
def test_fault_injected_scenario(seed):
    """A scripted schedule of dispatch raises and collect raises and
    corruptions (the sites where both packages fault alike)."""
    envs = observed_pair()
    for env in envs:
        four_cqs("6")(env)
        s = env.scheduler
        s.breaker = mod(env.pkg, "resilience.breaker").CircuitBreaker(
            threshold=2, backoff_base_s=2.0, jitter=0.0)
    rates = {"device_dispatch": 0.3, "device_collect": 0.3,
             "arena_scatter": 0.0, "journal_replay": 0.0,
             "speculation_validate": 0.0, "compile_warmup": 0.0}
    injectors = [mod(pkg, "resilience.faultinject").FaultInjector.scripted(
        seed, horizon=40, rates=rates) for pkg in PKGS]
    seen = [0]
    for c in range(8):
        wave(envs, 4, 4 * c)
        for env, inj in zip(envs, injectors):
            fi = mod(env.pkg, "resilience.faultinject")
            env.clock.advance(1.0)
            fi.install(inj)
            try:
                env.cycle()
            finally:
                fi.uninstall()
        check_pair(envs, seen)
        finish_some(envs, [f"default/w{4 * c + i}" for i in range(2)])
    assert injectors[1].fired == injectors[0].fired
    assert sum(t.faults for t in envs[1].scheduler.recorder.traces()) > 0
    finish(envs)


def test_pipelined_depth_one_scenario():
    p = Pipe(setup=four_cqs("8"))
    for env in p.envs:
        attach(env)
    seen = [0]
    for wave_i in range(5):
        p.submit_waves(1, start_wave=wave_i)
        p.advance(1.0)
        p.cycle()
        check_pair(p.envs, seen)
    for _ in range(3):
        p.cycle()
        check_pair(p.envs, seen)
    routes = [t.route for t in p.envs[1].scheduler.recorder.traces()]
    assert "device-pipelined" in routes and "drain" in routes
    finish(p.envs)


# --- tests/test_obs.py TestFlightRecorder, on the port's recorder ---

def test_recorder_ring_and_disabled_path():
    obs = mod(PORT, "obs")
    rec = obs.FlightRecorder(capacity=3)
    for i in range(10):
        tr = rec.begin_cycle(i)
        rec.span("apply", tr.t0, 0.001)
        rec.finish(tr)
    assert [t.cycle_id for t in rec.traces()] == [7, 8, 9]
    assert rec.cycles_recorded == 10
    off = obs.FlightRecorder(enabled=False)
    assert off.begin_cycle(1) is None
    off.span("apply", 0.0, 1.0)
    off.annotate("fault", "x")
    assert off.traces() == []
    with pytest.raises(ValueError):
        obs.FlightRecorder(capacity=0)
    tr = obs.CycleTrace(1, 0.0, 10.0)
    tr.spans = [("dispatch", 0.0, 0.5), ("dispatch.scatter", 0.0, 0.2),
                ("fetch", 0.5, 0.25), ("fetch", 0.8, 0.25)]
    assert tr.phase_sums() == {"dispatch": 0.5, "fetch": 0.5}


def test_disabled_recorder_keeps_admissions_and_gauges():
    envs = observed_pair()
    for env in envs:
        env.scheduler.recorder.enabled = False
        four_cqs("4")(env)
    wave(envs, 4, 0)
    for env in envs:
        env.cycle()
        assert env.scheduler.recorder.traces() == []
        assert env.scheduler.metrics.breaker_state.value() == 0
        assert math.isnan(env.scheduler.metrics.phase_percentile(
            "apply", 0.5))
    assert sorted(envs[1].client.applied) == sorted(envs[0].client.applied)


# --- tests/test_obs.py TestJourneyLedger, on the port's ledger ---

def _mk_info(i: int, cq: str = "cq"):
    """A minimal real Info of the port for direct ledger drives."""
    from tests.test_torch_scheduler import to_pkg
    wlpkg = mod(PORT, "core.workload")
    wl = to_pkg(WorkloadWrapper(f"storm{i}").queue("lq").creation(100 + i)
                .request("cpu", "1").obj(), PORT)
    info = wlpkg.Info(wl)
    info.cluster_queue = cq
    return info


class TestJourneyLedger:
    """tests/test_obs.py TestJourneyLedger on the port's JourneyLedger:
    LRU bounds, repeat collapse, exemplars, burn rates, close()."""

    def ledger(self, **kw):
        return mod(PORT, "obs").JourneyLedger(**kw)

    def test_validation(self):
        with pytest.raises(ValueError):
            self.ledger(capacity=0)
        with pytest.raises(ValueError):
            self.ledger(exemplars=0)

    def test_lru_eviction_under_50k_storm(self):
        led = self.ledger(capacity=1000,
                          metrics=mod(PORT, "metrics").Registry())
        led.begin_cycle(1, (1, 0, 0))
        n = 50_000
        for i in range(n):
            led.note_queue_delta("upsert", f"default/storm{i}",
                                 _mk_info(i))
        st = led.status()
        assert st["active"] == 1000
        assert st["started"] == n
        assert st["lru_evictions"] == n - 1000
        assert led.metrics.journey_ledger_evictions_total.value() \
            == n - 1000
        led.close()
        assert led.retained == 0

    def test_repeat_collapse_bounds_flood_timelines(self):
        reason = mod(PORT, "queue").RequeueReason
        led = self.ledger()
        info = _mk_info(0)
        led.begin_cycle(5, (1, 0, 0))
        led.note_queue_delta("upsert", info.key, info)
        for c in range(40):
            led.begin_cycle(5 + c, (1, 0, 0))
            led.requeued(info, "nominated",
                         reason.FAILED_AFTER_NOMINATION,
                         "Workload no longer fits")
        j = led.journey(info.key)
        assert [s.kind for s in j.spans] == ["queued", "requeued"]
        f = j.spans[-1].fields
        assert f["repeats"] == 40
        assert j.spans[-1].cycle == 5 and f["last_cycle"] == 44
        assert j.requeues == 40 and led.requeues_total == 40
        led.requeued(info, "nominated", reason.GENERIC, "other")
        assert [s.kind for s in led.journey(info.key).spans] \
            == ["queued", "requeued", "requeued"]

    def test_mid_cycle_arrival_stays_monotone(self):
        from tests.test_torch_scheduler import to_pkg
        reason = mod(PORT, "queue").RequeueReason
        clk = mod(PORT, "api.meta").FakeClock(100.0)
        led = self.ledger(clock=clk)
        led.begin_cycle(1, (1, 0, 0))
        wl = to_pkg(WorkloadWrapper("late").queue("lq").creation(100.5)
                    .request("cpu", "1").obj(), PORT)
        info = mod(PORT, "core.workload").Info(wl)
        info.cluster_queue = "cq"
        led.note_queue_delta("upsert", info.key, info)
        led.requeued(info, "nominated", reason.GENERIC)
        j = led.journey(info.key)
        assert [s.t for s in j.spans] == [100.5, 100.5]
        clk.advance(10.0)
        led.quota_reserved(wl, "cq", 10.0, admitted=True)
        ok, why = led.slowest(1)[0].timeline_complete()
        assert ok, why

    def test_span_cap_keeps_arrival_anchor(self):
        cap = mod(PORT, "obs.journey").MAX_SPANS_PER_JOURNEY
        reason = mod(PORT, "queue").RequeueReason
        led = self.ledger()
        info = _mk_info(0)
        led.begin_cycle(1, (1, 0, 0))
        led.note_queue_delta("upsert", info.key, info)
        for c in range(cap + 50):
            led.begin_cycle(1 + c, (1, 0, 0))
            led.requeued(info, "nominated", reason.GENERIC, f"msg{c}")
        j = led.journey(info.key)
        assert len(j.spans) == cap
        assert j.spans[0].kind == "queued"
        assert j.dropped_spans == 51

    def test_lru_evicted_journey_resumes_with_class_and_anchor(self):
        reason = mod(PORT, "queue").RequeueReason
        class_label = mod(PORT, "obs.journey").CLASS_LABEL
        reg = mod(PORT, "metrics").Registry()
        led = self.ledger(capacity=1, metrics=reg)
        led.begin_cycle(1, (1, 0, 0))
        prod = _mk_info(0)
        prod.obj.metadata.labels = {class_label: "prod"}
        led.note_queue_delta("upsert", prod.key, prod)
        led.note_queue_delta("upsert", "default/other", _mk_info(1))
        assert led.lru_evictions == 1
        led.requeued(prod, "nominated", reason.GENERIC)
        led.quota_reserved(prod.obj, "cq", 12.0, admitted=True)
        assert reg.journey_tta_seconds.count(cls="prod") == 1
        assert reg.journey_tta_seconds.count(cls="standard") == 0
        j = led.slowest(1)[0]
        assert j.spans[0].fields.get("resumed") is True
        ok, why = j.timeline_complete()
        assert ok, why

    def test_exemplars_keep_k_slowest_and_violations(self):
        led = self.ledger(exemplars=2)
        led.set_objectives({"standard": 25.0})
        led.begin_cycle(1, (1, 0, 0))
        for i, tta in enumerate([10.0, 50.0, 5.0, 30.0, 20.0]):
            info = _mk_info(i)
            led.note_queue_delta("upsert", info.key, info)
            led.quota_reserved(info.obj, "cq", tta, admitted=True)
        assert [j.tta_s for j in led.slowest()] == [50.0, 30.0]
        assert {j.tta_s for j in led.violations()} == {50.0, 30.0}
        assert led.journeys_completed == 5
        assert led.status()["active"] == 0
        assert led.burn_rates()["standard"] > 0

    def test_burn_rate_gauge_prices_objectives(self):
        reg = mod(PORT, "metrics").Registry()
        led = self.ledger(metrics=reg, error_budget=0.05, burn_alpha=1.0)
        led.set_objectives({"standard": 10.0})
        led.begin_cycle(1, (1, 0, 0))
        info = _mk_info(0)
        led.note_queue_delta("upsert", info.key, info)
        led.quota_reserved(info.obj, "cq", 99.0, admitted=True)
        assert reg.slo_burn_rate.value(cls="standard") \
            == pytest.approx(20.0)
        info2 = _mk_info(1)
        led.note_queue_delta("upsert", info2.key, info2)
        led.quota_reserved(info2.obj, "cq", 1.0, admitted=True)
        assert reg.slo_burn_rate.value(cls="standard") \
            == pytest.approx(0.0)


# --- tests/test_obs.py TestAgingWatch, on the port's watch ---

class TestAgingWatch:
    def monitor(self, *args, **kw):
        return mod(PORT, "obs").TrendMonitor(*args, **kw)

    def watch(self):
        return mod(PORT, "obs").AgingWatch()

    def test_monitor_flags_injected_leak_within_window(self):
        mon = self.monitor("leak", slope_threshold=0.05, window=12,
                           warmup=8)
        for _ in range(40):
            mon.sample(3.0)
        assert mon.verdict() == "ok"
        for i in range(8 + 12):
            mon.sample(3.0 + i)
        assert mon.verdict() == "leaking"

    def test_clean_sawtooth_stays_ok(self):
        mon = self.monitor("wal", slope_threshold=None, bound=200.0)
        v = 0.0
        for i in range(100):
            v = 0.0 if i % 10 == 0 else v + 10.0
            mon.sample(v)
        assert mon.verdict() == "ok"
        mon.sample(500.0)
        assert mon.verdict() == "over-bound"

    def test_watch_guards_dead_sources(self):
        watch = self.watch()

        def boom():
            raise RuntimeError("dead source")
        watch.add("bad", boom, slope_threshold=0.1)
        watch.sample()
        assert watch.monitors["bad"].sample_errors == 1
        assert watch.failing == []

    def test_scheduler_handout_leak_flagged_clean_run_silent(self):
        """The port's Scheduler with a watch on cache.live_handouts: a
        clean run stays ok, one unreleased snapshot a cycle is flagged
        within the window."""
        env = attach(Env(PORT, "device"))
        four_cqs("1000")(env)
        mon = env.scheduler.aging.monitors["live_handouts"]
        n = [0]

        def cycles(count, leak=False):
            for _ in range(count):
                env.submit(WorkloadWrapper(f"c{n[0]}").queue("lq-cq0")
                           .creation(float(n[0])).pod_set(count=1, cpu="1")
                           .obj())
                n[0] += 1
                env.cycle()
                env.clock.advance(1.0)
                if leak:
                    env.cache.snapshot()
        cycles(mon.warmup + mon.window + 4)
        assert mon.verdict() == "ok", mon.status()
        leak_start = mon.samples
        cycles(mon.warmup + mon.window + 8, leak=True)
        assert mon.verdict() == "leaking", mon.status()
        assert "live_handouts" in env.scheduler.aging.failing
        assert mon.samples - leak_start <= mon.warmup + mon.window + 8

    def test_verdict_walks_warming_ok_growing_leaking(self):
        mon = self.monitor("walk", slope_threshold=0.05, alpha=0.5,
                           window=6, warmup=4)
        for _ in range(4):
            mon.sample(10.0)
            assert mon.verdict() == "warming"
        mon.sample(10.0)
        assert mon.verdict() == "ok"
        v, seen = 10.0, []
        while mon.verdict() != "leaking":
            v += 1.0
            mon.sample(v)
            seen.append(mon.verdict())
        assert seen[:-1] == ["growing"] * (len(seen) - 1)
        assert mon.sustained >= mon.window

    def test_over_bound_outranks_every_other_verdict(self):
        mon = self.monitor("ceil", slope_threshold=0.05, bound=100.0,
                           window=6, warmup=4)
        mon.sample(150.0)
        assert mon.samples <= mon.warmup
        assert mon.verdict() == "over-bound"
        mon.sample(50.0)
        assert mon.verdict() == "warming"

    def test_slope_ewma_decays_back_to_ok_after_leak(self):
        mon = self.monitor("decay", slope_threshold=0.05, alpha=0.5,
                           window=4, warmup=2)
        v = 0.0
        for _ in range(12):
            v += 1.0
            mon.sample(v)
        assert mon.verdict() == "leaking"
        flats = 0
        while mon.verdict() != "ok":
            mon.sample(v)
            flats += 1
            assert flats < 20, "slope EWMA never decayed"
        assert mon.sustained == 0

    def test_dead_source_counted_per_pass_never_failing(self):
        watch = self.watch()

        def boom():
            raise RuntimeError("dead source")
        watch.add("bad", boom, slope_threshold=0.1)
        watch.add("good", lambda: 1.0, slope_threshold=0.1, warmup=0)
        for _ in range(3):
            watch.sample()
        assert watch.monitors["bad"].sample_errors == 3
        assert watch.monitors["bad"].samples == 0
        assert watch.monitors["good"].samples == 3
        assert watch.failing == []
        assert watch.gate()["ok"] is True

    def test_gate_contract_and_status_carry_it_verbatim(self):
        watch = self.watch()
        watch.add("flat", lambda: 5.0, slope_threshold=0.1, warmup=0)
        leak = {"v": 0.0}

        def leaking():
            leak["v"] += 1.0
            return leak["v"]
        watch.add("leak", leaking, slope_threshold=0.05, alpha=0.5,
                  window=4, warmup=2)
        watch.sample()
        g = watch.gate()
        assert set(g) == {"ok", "failing", "verdicts"}
        assert g["ok"] is True and g["failing"] == []
        for _ in range(12):
            watch.sample()
        g = watch.gate()
        assert g["ok"] is False and g["failing"] == ["leak"]
        assert g["verdicts"]["leak"] == "leaking"
        assert g["verdicts"]["flat"] == "ok"
        assert watch.status()["gate"] == g
        assert mod(PORT, "obs.trend").rss_kb() > 0

    @pytest.mark.parametrize("shape", ("ramp", "sawtooth", "late-burst"))
    def test_monitor_verdicts_equal_jax(self, shape):
        values = {"ramp": [float(i) for i in range(60)],
                  "sawtooth": [float(i % 5) for i in range(60)],
                  "late-burst": [0.0] * 20 + [float(i * i)
                                              for i in range(40)]}[shape]
        got = []
        for pkg in PKGS:
            mon = mod(pkg, "obs").TrendMonitor("m", slope_threshold=0.5,
                                               window=16, bound=500.0)
            row = []
            for v in values:
                mon.sample(v)
                row.append(mon.verdict())
            row.append(mon.status())
            got.append(row)
        assert got[1] == got[0]


def test_status_producers_equal_jax():
    envs = observed_pair()
    for env in envs:
        four_cqs("4")(env)
        env.scheduler.solver_routing = "adaptive"
    wave(envs, 8, 0)
    for _ in range(3):
        for env in envs:
            env.cycle()
    rows = []
    for env in envs:
        obs = mod(env.pkg, "obs")
        s = env.scheduler
        rows.append(dict(
            degrade=obs.degrade_status(s),
            pipeline=obs.pipeline_status(s),
            warmup=obs.warmup_status(s),
            recovery=obs.recovery_status(s),
            queryplane=obs.queryplane_status(s),
            shards=obs.shards_status(s),
            router={k: v for k, v in obs.router_status(s).items()
                    if k != "regimes"},
            journeys=obs.journey_status(s),
            arena={k: v for k, v in obs.arena_status(s.solver).items()
                   if k not in ("gathers",)},
            breaker={k: v for k, v in obs.breaker_status(s).items()
                     if k not in ("supervised_dispatch",)},
        ))
        endpoints = obs.DebugEndpoints(s, s.metrics)
        assert endpoints.handle("/debug/router", {})["routing"] == "adaptive"
        assert "kueue_" in endpoints.metrics_text()
    assert rows[1] == rows[0]
