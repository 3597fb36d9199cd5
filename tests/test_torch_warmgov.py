"""The port's compile governor (kueue_tpu_torch/solver/warmgov.py)
driving the port's BatchSolver on the CPU (its kernels' plain versions),
against the JAX package's governor on the same topology, and
tests/test_warmgov.py's TestLadderDerivation, TestRouteGate,
TestWarmupChaos and TestOperatorSurface on the port.

Held equal with no tolerance: the governor's status() (less the bucket
times, compile_ms, the provenance, `source`, which reads jax's
compilation cache on one side and the kernel build on the other, and
the JAX governor's cache directory, `cache_dir` and `cache_subdir`,
which the port does not keep) and programs_warmed after run_sync, and
the solvers' counters["mid_traffic_compiles"]: 0 on a warmed
synchronous cycle, the same count for a narrow batch in a wide bucket
(whose padding rows both keys count into CQ 0's rank rung), and,
unwarmed, the same count on the pipelined path (where both packages run
the same programs: the router, then the resident dispatch). The port
narrows containment: a non-DeviceFault raised in a warm propagates from
run_sync, and from the background walk it reaches the Scheduler's next
cycle. A solver on the card (`warm_ladder` False, faked here) leaves
the governor warm from its start and keys no program.
"""

import importlib
import json
import time

import pytest

import kueue_tpu.solver.kernel  # noqa: F401  enables jax x64 before any array
from tests.test_torch_pipeline import Pipe
from tests.test_torch_scheduler import PKGS, Env
from tests.wrappers import ClusterQueueWrapper, WorkloadWrapper, flavor_quotas

JAX, PORT = PKGS


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


warmgov = mod(PORT, "solver.warmgov")
fi = mod(PORT, "resilience.faultinject")
(B_SKIPPED, B_WARM, GOV_IDLE, GOV_PARTIAL, GOV_WARM, GOV_WARMING,
 CompileGovernor, rank_ladder, snapshot_cohort_members, width_ladder) = (
    warmgov.B_SKIPPED, warmgov.B_WARM, warmgov.GOV_IDLE,
    warmgov.GOV_PARTIAL, warmgov.GOV_WARM, warmgov.GOV_WARMING,
    warmgov.CompileGovernor, warmgov.rank_ladder,
    warmgov.snapshot_cohort_members, warmgov.width_ladder)


@pytest.fixture(autouse=True)
def _clean():
    for pkg in PKGS:
        mod(pkg, "solver.service").reset_seen_programs()
    yield
    for pkg in PKGS:
        mod(pkg, "resilience.faultinject").uninstall()


def simple_env(num_cqs=1, cohort=None, pkg=PORT, route="cpu"):
    env = Env(pkg, route)
    env.add_flavor("default")
    for i in range(num_cqs):
        cq = ClusterQueueWrapper(f"cq{i}") \
            .resource_group(flavor_quotas("default", cpu="100"))
        if cohort is not None:
            cq = cq.cohort(cohort)
        env.add_cq(cq.obj(), f"lq{i}")
    return env


class StubWarmSolver:
    """tests/test_warmgov.py's warm-capable stub: the governor's control
    flow without running the programs."""

    max_podsets = 4

    def __init__(self):
        self.warm_calls = []

    def warm_setup(self, snapshot, expected_pending=None):
        ctx = type("Ctx", (), {})()
        ctx.topo = None
        return ctx

    def warm_router(self, ctx, width):
        self.warm_calls.append(("router", width))
        return 1

    def warm_bucket(self, ctx, width, max_ranks=(8, 32),
                    deltas_buckets=(8,), fair_sharing=False):
        self.warm_calls.append(("bucket", width))
        return 2

    def warm_scatter(self, ctx):
        self.warm_calls.append(("scatter", None))
        return 1


class TestLadderDerivation:
    def test_width_ladder_is_geometric_largest_first(self):
        assert width_ladder(1) == [8]
        assert width_ladder(8) == [8]
        assert width_ladder(9) == [32, 8]
        assert width_ladder(2048) == [2048, 512, 128, 32, 8]
        assert width_ladder(100_000, max_width=512) == [512, 128, 32, 8]

    def test_rank_ladder_covers_through_one_past_the_bound(self):
        assert rank_ladder({"a": 1}) == (8, 32)
        assert rank_ladder({"a": 20, "b": 2}) == (8, 32, 128)

    def test_cohort_members_from_snapshot(self):
        env = simple_env(num_cqs=3, cohort="co")
        snap = env.cache.snapshot()
        assert snapshot_cohort_members(snap) == {"co": 3}
        env.cache.release_snapshot(snap)
        env2 = simple_env(num_cqs=2)
        snap = env2.cache.snapshot()
        assert snapshot_cohort_members(snap) == {"cq0": 1, "cq1": 1}
        env2.cache.release_snapshot(snap)

    @pytest.mark.parametrize("members,width,extra", [
        ({"cohort-0": 24}, 64, ()),
        ({"a": 3, "b": 40}, 2048, ("B256xK512", (16, 64))),
        ({"x": 1}, 8, ()),
    ])
    def test_ladders_equal_jax(self, members, width, extra):
        jgov = mod(JAX, "solver.warmgov")
        assert warmgov.preempt_shape_ladder(members, width, extra) \
            == jgov.preempt_shape_ladder(members, width, extra)
        assert rank_ladder(members) == jgov.rank_ladder(members)
        for n in (1, 9, 100, 2048, 5000):
            assert width_ladder(n) == jgov.width_ladder(n)
        for rung in extra:
            assert warmgov.parse_shape_rung(rung) \
                == jgov.parse_shape_rung(rung)
        with pytest.raises(ValueError):
            warmgov.parse_shape_rung("bad")

    def test_governor_plumbs_extra_rungs(self):
        env = simple_env(num_cqs=2, cohort="co")
        gov = CompileGovernor(StubWarmSolver(), env.cache,
                              extra_preempt_rungs=("B256xK512",))
        gov.run_sync()
        keys = {(s["B"], s["K"]) for s in gov._preempt_shapes}
        assert (256, 512) in keys
        assert env.cache.live_handouts == 0  # the walk's snapshot released


class TestRouteGate:
    def test_idle_governor_never_gates(self):
        gov = CompileGovernor(StubWarmSolver(), None)
        assert gov.state == GOV_IDLE
        assert gov.route_ready(1) and gov.route_ready(2048)

    def test_started_governor_gates_until_the_bucket_is_warm(self):
        gov = CompileGovernor(StubWarmSolver(), None)
        gov.state = GOV_WARMING
        assert not gov.route_ready(10)
        gov._warm_widths = frozenset([32])
        assert gov.route_ready(10)
        assert not gov.route_ready(100)

    def test_scheduler_routes_cpu_warmup_and_requests_the_bucket(self):
        env = simple_env()
        env.scheduler.solver_min_heads = 0
        env.scheduler.metrics = mod(PORT, "metrics").Registry()
        gov = CompileGovernor(StubWarmSolver(), env.cache)
        gov.start = lambda: None
        gov.state = GOV_WARMING
        env.scheduler.warm_gov = gov
        env.submit(WorkloadWrapper("w").queue("lq0")
                   .pod_set(count=1, cpu="2").obj())
        env.cycle()
        assert "default/w" in env.client.applied
        assert env.scheduler.cycle_counts == {"cpu-warmup": 1}
        assert gov.unwarm_routed == 1
        assert not env.scheduler._route_stats
        assert env.scheduler.solver.counters["dispatches"] == 0
        assert list(gov._requests) == [8]

    def test_mesh_backend_is_vacuously_warm(self):
        class MeshSolver(StubWarmSolver):
            def warm_setup(self, snapshot, expected_pending=None):
                return None

        env = simple_env()
        gov = CompileGovernor(MeshSolver(), env.cache)
        gov.run_sync()
        assert gov.state == GOV_WARM
        assert gov.route_ready(8) and gov.route_ready(2048)
        gov.request(8)
        assert not gov._requests and gov.unwarm_routed == 0

    def test_card_solver_is_warm_from_start(self):
        class CardSolver(StubWarmSolver):
            warm_ladder = False

        gov = CompileGovernor(CardSolver(), None)
        gov.start()
        assert gov.state == GOV_WARM and gov._thread is None
        assert gov.route_ready(8) and gov.route_ready(2048)
        gov.request(2048)
        assert not gov._requests and gov.unwarm_routed == 0
        st = gov.status()
        assert st["buckets"] == [] and st["programs_warmed"] == 0
        assert st["source"] == "jit-cache"  # nothing built here

    def test_card_scheduler_keys_no_program(self, monkeypatch):
        """The port's BatchSolver as on the card (its warm_ladder False):
        warm_setup builds no context, the governor never gates, and the
        device cycle keys no program variant and counts none."""
        svc = mod(PORT, "solver.service")
        monkeypatch.setattr(svc.BatchSolver, "warm_ladder",
                            property(lambda self: False))
        env = simple_env()
        env.scheduler.solver_min_heads = 0
        solver = env.scheduler.solver
        gov = CompileGovernor(solver, env.cache)
        env.scheduler.warm_gov = gov
        gov.start()
        assert gov.state == GOV_WARM
        env.submit(WorkloadWrapper("w").queue("lq0")
                   .pod_set(count=1, cpu="2").obj())
        env.cycle()
        assert "default/w" in env.client.applied
        assert env.scheduler.cycle_counts == {"device": 1}
        assert gov.run_sync() == 0 and gov.buckets == {}
        assert solver.counters["mid_traffic_compiles"] == 0
        assert not svc._SEEN_PROGRAMS

    def test_request_created_bucket_refreshed_by_walk(self):
        env = simple_env(num_cqs=30, cohort="co")
        gov = CompileGovernor(StubWarmSolver(), env.cache)
        gov.start = lambda: None
        gov.state = GOV_WARMING
        gov.request(20)
        assert gov.buckets[32].ranks == (8, 32)
        assert not gov.buckets[32].scatter
        gov.run_sync()
        assert gov.state == GOV_WARM
        assert gov.buckets[32].ranks == (8, 32, 128)
        assert gov.buckets[32].scatter

    def test_warmed_sync_dispatch_counts_no_mid_traffic_compiles(self):
        """A real warm on the port's BatchSolver, then a real
        synchronous device cycle: every variant the dispatch keys was
        registered by the warm, so mid_traffic_compiles stays 0."""
        env = simple_env()
        solver = env.scheduler.solver
        env.scheduler.solver_min_heads = 0
        gov = CompileGovernor(solver, env.cache, warm_preempt=False)
        assert gov.run_sync() > 0
        assert gov.state == GOV_WARM
        env.scheduler.warm_gov = gov
        env.submit(WorkloadWrapper("w").queue("lq0")
                   .pod_set(count=1, cpu="2").obj())
        env.cycle()
        assert "default/w" in env.client.applied
        assert env.scheduler.cycle_counts.get("device") == 1
        assert solver.counters["mid_traffic_compiles"] == 0

    def test_warm_bucket_routes_device_again(self):
        env = simple_env()
        env.scheduler.solver_min_heads = 0
        gov = CompileGovernor(StubWarmSolver(), env.cache)
        gov.state = GOV_WARM
        gov._warm_widths = frozenset([8])
        env.scheduler.warm_gov = gov
        env.submit(WorkloadWrapper("w").queue("lq0")
                   .pod_set(count=1, cpu="2").obj())
        env.cycle()
        assert "default/w" in env.client.applied
        assert env.scheduler.cycle_counts.get("device") == 1
        assert gov.unwarm_routed == 0


class TestWarmupChaos:
    def test_hang_then_error_skips_the_bucket_not_startup(self):
        env = simple_env()
        metrics = mod(PORT, "metrics").Registry()
        gov = CompileGovernor(StubWarmSolver(), env.cache,
                              metrics=metrics, bucket_deadline_s=0.05)
        fi.install(fi.FaultInjector(
            {fi.SITE_WARMUP: {0: (fi.DELAY, 0.3), 1: fi.RAISE}}))
        gov.run_sync()
        fi.uninstall()
        assert gov.state == GOV_PARTIAL
        (b,) = gov.buckets.values()
        assert b.state == B_SKIPPED and b.attempts == 2
        assert b.error
        assert gov.warmup_faults == 2
        assert metrics.warmup_faults_total.value() == 2
        gov.request(4)
        assert not gov._requests
        env.scheduler.warm_gov = gov
        env.scheduler.solver_min_heads = 0
        env.submit(WorkloadWrapper("w").queue("lq0")
                   .pod_set(count=1, cpu="2").obj())
        env.cycle()
        assert "default/w" in env.client.applied
        assert env.scheduler.cycle_counts == {"cpu-warmup": 1}
        assert env.scheduler.breaker.state == "closed"
        assert env.scheduler.solver_faults == 0
        gov.stop()

    def test_background_start_completes_under_chaos(self):
        env = simple_env()
        gov = CompileGovernor(StubWarmSolver(), env.cache,
                              bucket_deadline_s=5.0)
        fi.install(fi.FaultInjector({fi.SITE_WARMUP: {0: fi.RAISE}}))
        gov.start()
        assert gov.state == GOV_WARMING
        try:
            deadline = time.time() + 10.0
            while gov.state == GOV_WARMING and time.time() < deadline:
                time.sleep(0.01)
        finally:
            fi.uninstall()
            gov.stop()
        assert gov.state == GOV_WARM
        (b,) = gov.buckets.values()
        assert b.state == B_WARM and b.attempts == 2
        assert gov.warmup_faults == 1

    def test_background_walk_rewalks_on_structural_change(self):
        env = simple_env()
        solver = StubWarmSolver()
        gov = CompileGovernor(solver, env.cache)
        toks = iter([1, 2])
        gov._gen_token = lambda: next(toks, 2)
        gov.start()
        deadline = time.time() + 10.0
        while gov.state == GOV_WARMING and time.time() < deadline:
            time.sleep(0.01)
        gov.stop()
        assert gov.state == GOV_WARM
        assert len([c for c in solver.warm_calls if c[0] == "bucket"]) == 2

    def test_walk_level_device_fault_is_contained(self):
        """A DeviceFault out of warm_setup degrades to the route gate,
        counted (the JAX governor contains any exception here)."""
        class FaultySolver(StubWarmSolver):
            def warm_setup(self, snapshot, expected_pending=None):
                raise fi.InjectedFault(fi.SITE_WARMUP, 0)

        env = simple_env()
        metrics = mod(PORT, "metrics").Registry()
        gov = CompileGovernor(FaultySolver(), env.cache, metrics=metrics)
        assert gov.run_sync() == 0
        assert gov.state == GOV_PARTIAL
        assert gov.warmup_faults == 1
        assert metrics.warmup_faults_total.value() == 1

    def test_other_walk_failure_propagates_from_run_sync(self):
        class BrokenSolver(StubWarmSolver):
            def warm_setup(self, snapshot, expected_pending=None):
                raise RuntimeError("boom")

        env = simple_env()
        gov = CompileGovernor(BrokenSolver(), env.cache)
        with pytest.raises(RuntimeError, match="boom"):
            gov.run_sync()
        assert gov.warmup_faults == 0
        assert env.cache.live_handouts == 0

    def test_non_device_fault_in_a_warm_reaches_the_scheduler(self):
        """An exception of a bucket warm that is not a DeviceFault (an
        nvcc failure, a CUDA error, a bug) is not contained: from
        run_sync it propagates, and from the background walk it is raised
        by the Scheduler's next cycle (route_ready)."""
        class BrokenWarm(StubWarmSolver):
            def warm_bucket(self, ctx, width, **kw):
                raise RuntimeError("nvcc failed")

        env = simple_env()
        gov = CompileGovernor(BrokenWarm(), env.cache)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            gov.run_sync()
        assert gov.warmup_faults == 0

        env = simple_env()
        env.scheduler.solver_min_heads = 0
        gov = CompileGovernor(BrokenWarm(), env.cache)
        env.scheduler.warm_gov = gov
        gov.start()
        deadline = time.time() + 10.0
        while gov._error is None and time.time() < deadline:
            time.sleep(0.01)
        gov.stop()
        env.submit(WorkloadWrapper("w").queue("lq0")
                   .pod_set(count=1, cpu="2").obj())
        with pytest.raises(RuntimeError, match="nvcc failed"):
            env.cycle()
        assert not env.client.applied


class TestOperatorSurface:
    def test_debug_warmup_endpoint(self):
        obs = mod(PORT, "obs")
        env = simple_env()
        ep = obs.DebugEndpoints(env.scheduler)
        unattached = ep.handle("/debug/warmup", {})
        assert unattached.pop("generation") == \
            list(env.cache.generation_token())
        assert unattached == {"attached": False}
        gov = CompileGovernor(StubWarmSolver(), env.cache)
        gov.run_sync()
        env.scheduler.warm_gov = gov
        st = ep.handle("/debug/warmup", {})
        assert st["attached"] and st["state"] == GOV_WARM
        assert st["buckets"] and st["buckets"][0]["state"] == B_WARM
        assert st["cpu_warmup_cycles"] == 0
        st.pop("generation")
        assert st == obs.warmup_status(env.scheduler)

    def test_governor_status_roundtrips_json(self):
        env = simple_env()
        gov = CompileGovernor(StubWarmSolver(), env.cache)
        gov.run_sync()
        json.dumps(gov.status())

    def test_metrics_warmup_state_gauge(self):
        reg = mod(PORT, "metrics").Registry()
        for state, code in (("idle", 0), ("warming", 1), ("warm", 2),
                            ("partial", 3)):
            reg.set_warmup_state(state)
            assert reg.warmup_state.value() == code


# --- the governor against the JAX package's, on the same topology ---

def status_row(gov) -> dict:
    st = gov.status()
    for key in ("worker", "cache_dir", "cache_subdir", "source"):
        st.pop(key, None)
    st["buckets"] = [{k: v for k, v in b.items()
                      if k not in ("compile_ms", "source")}
                     for b in st["buckets"]]
    return st


@pytest.mark.parametrize("num_cqs,cohort", [(1, None), (3, "co")])
def test_run_sync_equal_jax(num_cqs, cohort):
    envs = [simple_env(num_cqs, cohort, pkg=pkg, route="device")
            for pkg in PKGS]
    govs = []
    for env in envs:
        gov = mod(env.pkg, "solver.warmgov").CompileGovernor(
            env.scheduler.solver, env.cache, warm_preempt=False,
            deltas_buckets=(8,))
        assert gov.run_sync() > 0
        env.scheduler.warm_gov = gov
        govs.append(gov)
    assert status_row(govs[1]) == status_row(govs[0])
    assert govs[1].programs_warmed == govs[0].programs_warmed
    for env in envs:
        for i in range(num_cqs):
            env.submit(WorkloadWrapper(f"w{i}").queue(f"lq{i}")
                       .pod_set(count=1, cpu="2").obj())
        env.cycle()
        assert env.scheduler.cycle_counts == {"device": 1}
    got = [env.scheduler.solver.counters["mid_traffic_compiles"]
           for env in envs]
    assert got == [0, 0]
    assert sorted(envs[1].client.applied) == sorted(envs[0].client.applied)


def test_narrow_batch_in_wide_bucket_equal_jax():
    """33 heads, one in each of 33 CQs without a cohort, encode into the
    128 bucket. The warm's rank ladder is (8, 32), one rung past the
    largest cohort; both keys count the bucket's 95 padding rows into CQ
    0's domain (96 rows: rung 128), so both packages count the same
    mid-traffic compiles for the first cycle, and none for a second
    cycle of the same shape."""
    envs = [simple_env(33, pkg=pkg, route="device") for pkg in PKGS]
    for env in envs:
        env.scheduler.solver_min_heads = 0
        gov = mod(env.pkg, "solver.warmgov").CompileGovernor(
            env.scheduler.solver, env.cache, warm_preempt=False,
            deltas_buckets=(8,))
        assert gov.run_sync() > 0
        env.scheduler.warm_gov = gov
    got = []
    for wave in range(2):
        for env in envs:
            for i in range(33):
                env.submit(WorkloadWrapper(f"w{wave}-{i}").queue(f"lq{i}")
                           .pod_set(count=1, cpu="2").obj())
            env.cycle()
            assert env.scheduler.cycle_counts == {"device": wave + 1}
        got.append([env.scheduler.solver.counters["mid_traffic_compiles"]
                    for env in envs])
    assert got[0][1] == got[0][0] > 0
    assert got[1] == got[0]
    assert sorted(envs[1].client.applied) == sorted(envs[0].client.applied)


def test_preempt_warm_counts_equal_jax():
    """warm_preempt_bucket over two ladder shapes at one rank rung: the
    programs counted as the JAX solver counts them, and the same keys
    registered (the ladder is cut to keep the JAX compiles short)."""
    shapes = ({"B": 8, "K": 32, "QL": 8, "CL": 8, "RF": 8, "U": 4},
              {"B": 8, "K": 8, "QL": 1, "CL": 8, "RF": 8, "U": 4})
    got = []
    for pkg in PKGS:
        env = simple_env(2, "co", pkg=pkg, route="device")
        solver = env.scheduler.solver
        snap = env.cache.snapshot()
        ctx = solver.warm_setup(snap)
        env.cache.release_snapshot(snap)
        svc = mod(pkg, "solver.service")
        n = solver.warm_preempt_bucket(ctx, 8, shapes, max_ranks=(8,),
                                       deltas_buckets=(), start_rank=True)
        keys = sorted(repr(k[:1] + k[2:]) for k in svc._SEEN_PROGRAMS
                      if k[0] != "preempt-solve")
        got.append((n, len(keys)))
    assert got[1] == got[0] == (4, 4)


def test_unwarmed_pipelined_mid_traffic_compiles_equal_jax():
    p = Pipe()
    for wave in range(3):
        p.submit_waves(1, start_wave=wave)
        p.cycle()
    p.settle()
    got = [env.scheduler.solver.counters["mid_traffic_compiles"]
           for env in p.envs]
    assert got[1] == got[0] > 0
    notes = [[a for t in env.scheduler.recorder.traces()
              for a in t.annotations if a["kind"] == "compile"]
             for env in p.envs]
    assert [(a["program"], a["width"]) for a in notes[1]] \
        == [(a["program"], a["width"]) for a in notes[0]]
