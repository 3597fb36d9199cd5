"""The port's query plane (kueue_tpu_torch/obs/queryplane.py) against the
JAX package's, and tests/test_queryplane.py's cases that need neither
KueueManager nor visibility.py, on the port.

The paired runs wire a QueryPlane onto each package's Scheduler
(tests/test_torch_scheduler.py's Env, on the device route and on the CPU
one) and after every cycle hold equal, with no tolerance: the sealed
view's cycle, route and generation, pending_cq and pending_lq of every
queue (names, positions, priorities, nominate ranks), workload_status of
every workload submitted, and cache.live_handouts, which must be exactly
what the plane holds (1 once a synchronous cycle sealed its snapshot).
"""

import dataclasses
import importlib
import random
import threading

import pytest

import kueue_tpu.solver.kernel  # noqa: F401  enables jax x64 before any array
from tests.test_torch_pipeline import Pipe, four_cqs
from tests.test_torch_scheduler import PKGS, Env
from tests.wrappers import ClusterQueueWrapper, WorkloadWrapper, flavor_quotas

JAX, PORT = PKGS


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class QEnv:
    """One package's Scheduler with a query plane, on `route`."""

    def __init__(self, pkg=PORT, route="device", cqs=2, quota=2,
                 cohort=None):
        self.env = Env(pkg, route)
        env = self.env
        env.add_flavor("default")
        for c in range(cqs):
            w = ClusterQueueWrapper(f"cq{c}")
            if cohort:
                w = w.cohort(cohort)
            env.add_cq(w.resource_group(flavor_quotas(
                "default", cpu=quota)).obj(), f"lq{c}")
        self.qp = mod(pkg, "obs.queryplane").QueryPlane(
            env.cache, env.queues, metrics=mod(pkg, "metrics").Registry())
        env.scheduler.query_plane = self.qp
        self.names = []
        self._gone: set = set()

    @property
    def cache(self):
        return self.env.cache

    def submit(self, n, lq="lq0", prefix="w", cpu="1", start=0):
        for i in range(start, start + n):
            self.env.submit(WorkloadWrapper(f"{prefix}{i}").queue(lq)
                            .creation(100 + i).request("cpu", cpu).obj())
            self.names.append(f"{prefix}{i}")

    def cycle(self):
        """One cycle; then, as the manager's workload controller does on
        the admission write, the admitted workloads leave the queues."""
        sig = self.env.cycle()
        for key, wl in self.env.client.applied.items():
            if key not in self._gone:
                self._gone.add(key)
                self.env.queues.delete_workload(wl)
        return sig

    def settle(self, limit=10):
        """Cycles (with inadmissible flushes) until nothing admits."""
        for _ in range(limit):
            before = len(self.env.client.applied)
            self.env.queues.queue_inadmissible_workloads(
                set(self.env.cq_names))
            self.cycle()
            if len(self.env.client.applied) == before:
                return

    def bump_quota(self, cq="cq0", cpu=3):
        obj = (ClusterQueueWrapper(cq).resource_group(
            flavor_quotas("default", cpu=cpu)).obj())
        obj = self.env.conv(obj)
        self.cache.update_cluster_queue(obj)
        self.env.queues.update_cluster_queue(obj)

    def read(self) -> dict:
        qp = self.qp
        view = qp.acquire()
        if view is None:
            return {"warming": True}
        try:
            out = {"cycle": view.cycle_id, "route": view.route,
                   "generation": view.generation,
                   "live_handouts": self.cache.live_handouts}
            for c in self.env.cq_names:
                out[f"cq:{c}"] = [dataclasses.astuple(r) for r in
                                  qp.pending_cq(view, c, 100, 0)]
            for lq in sorted(self.env.queues.local_queues):
                ns, name = lq.split("/", 1)
                out[f"lq:{lq}"] = [dataclasses.astuple(r) for r in
                                   qp.pending_lq(view, ns, name, 100, 0)]
            for name in self.names + ["zzz"]:
                st = qp.workload_status(view, "default", name)
                out[f"wl:{name}"] = {k: v for k, v in st.items()
                                     if k not in ("age_s",)}
            return out
        finally:
            qp.release(view)


def strip_age(row):
    if isinstance(row, dict):
        return {k: strip_age(v) for k, v in row.items()
                if k not in ("age_s", "t_wall")}
    return row


@pytest.mark.parametrize("route", ("device", "cpu"))
def test_sealed_views_equal_jax(route):
    pair = [QEnv(pkg, route, cqs=3, quota=3, cohort="co") for pkg in PKGS]
    rng = random.Random(11)
    n = 0
    for step in range(8):
        for _ in range(rng.randint(1, 4)):
            lq = f"lq{rng.randrange(3)}"
            cpu = str(rng.choice([1, 2]))
            for q in pair:
                q.submit(1, lq=lq, cpu=cpu, start=n)
            n += 1
        for q in pair:
            q.cycle()
        rows = [strip_age(q.read()) for q in pair]
        assert rows[1] == rows[0], step
        for q in pair:
            assert q.cache.live_handouts == 1
        if step % 3 == 2:
            for q in pair:
                admitted = sorted(q.env.client.applied)[:1]
                for key in admitted:
                    q.cache.delete_workload(q.env.client.applied.pop(key))
                q.env.queues.queue_inadmissible_workloads(
                    set(q.env.cq_names))
    for q in pair:
        q.qp.close()
        assert q.cache.live_handouts == 0


def test_pipelined_seals_equal_jax():
    """Pipelined cycles seal without a snapshot: the views share the
    last synchronous handout, and live_handouts stays what the plane
    holds."""
    p = Pipe(setup=four_cqs("8"))
    planes = []
    for env in p.envs:
        qp = mod(env.pkg, "obs.queryplane").QueryPlane(env.cache,
                                                       env.queues)
        env.scheduler.query_plane = qp
        planes.append(qp)
    for w in range(4):
        p.submit_waves(1, start_wave=w)
        p.cycle()
        views = [qp.acquire() for qp in planes]
        try:
            stamps = [None if v is None else (v.cycle_id, v.route)
                      for v in views]
            assert stamps[1] == stamps[0]
            held = [qp.status()["holds_snapshot_handout"] for qp in planes]
            assert held[1] == held[0]
        finally:
            for qp, v in zip(planes, views):
                qp.release(v)
        got = [env.cache.live_handouts for env in p.envs]
        assert got[1] == got[0]
    p.settle()
    for qp, env in zip(planes, p.envs):
        qp.close()
        assert env.cache.live_handouts == 0


# --- tests/test_queryplane.py, on the port ---

class TestSealedViewLifecycle:
    def test_warming_until_first_publish(self):
        q = QEnv()
        assert q.qp.warming and q.qp.acquire() is None
        assert q.qp.token_lag() is None
        q.submit(1)
        q.cycle()
        assert not q.qp.warming
        view = q.qp.acquire()
        assert view is not None and view.cycle_id > 0
        assert view.generation == q.cache.generation_token()
        q.qp.release(view)

    def test_every_cycle_seal_publishes(self):
        q = QEnv()
        q.submit(3)
        before = q.qp.cycles_published
        q.cycle()
        assert q.qp.cycles_published == before + 1
        q.env.queues.queue_inadmissible_workloads({"cq0"})
        q.cycle()
        assert q.qp.cycles_published == before + 2

    def test_publish_without_snapshot_shares_previous_handout(self):
        q = QEnv()
        q.submit(2)
        q.cycle()
        v1 = q.qp.acquire()
        snap = v1.snapshot
        assert snap is not None
        q.qp.release(v1)
        taken = q.cache.handouts_taken
        q.qp.publish(999, "drain", [], snapshot=None)
        assert q.cache.handouts_taken == taken
        v2 = q.qp.acquire()
        assert v2.cycle_id == 999 and v2.snapshot is snap
        q.qp.release(v2)
        assert q.cache.live_handouts == 1
        q.qp.close()
        assert q.cache.live_handouts == 0

    def test_borrow_defers_release_across_publish(self):
        q = QEnv()
        q.submit(3)
        q.cycle()
        held = q.qp.acquire()
        held_snap = held.snapshot
        q.env.queues.queue_inadmissible_workloads({"cq0"})
        q.cycle()
        assert q.cache.live_handouts == 2
        assert held.retired
        q.qp.release(held)
        assert q.cache.live_handouts == 1
        assert held.snapref is None
        view = q.qp.acquire()
        assert held_snap is not view.snapshot
        q.qp.release(view)

    def test_parked_seal_snapshot_never_strands(self):
        q = QEnv()
        q.submit(4)
        q.cycle()
        assert q.cache.live_handouts == 1
        q.env.scheduler._seal_snapshot = q.cache.snapshot()
        assert q.cache.live_handouts == 2
        q.env.queues.queue_inadmissible_workloads({"cq0"})
        q.cycle()  # the cycle's start flushes the parked handout
        assert q.cache.live_handouts == 1
        q.qp.close()
        assert q.cache.live_handouts == 0

    def test_snapshotless_seals_keep_the_transitioning_witness(self):
        q = QEnv(quota=2)
        q.submit(1)
        q.cycle()
        q.qp.publish(101, "device-pipelined", ["default/x1"], snapshot=None)
        q.qp.publish(102, "device-pipelined", ["default/x2"], snapshot=None)
        view = q.qp.acquire()
        try:
            st = q.qp.workload_status(view, "default", "w0")
            assert st["found"] is True
            assert st["status"] in ("transitioning", "admitted")
            st = q.qp.workload_status(view, "default", "zzz")
            assert st["found"] is False and st["status"] == "unknown"
        finally:
            q.qp.release(view)
        q.submit(1, prefix="y")
        q.cycle()
        assert len(q.qp._order_chain) == 1
        q.qp.close()
        assert q.cache.live_handouts == 0

    def test_scheduler_without_plane_releases_as_before(self):
        env = Env(PORT, "device")
        env.add_flavor("default")
        env.add_cq(ClusterQueueWrapper("cq").resource_group(
            flavor_quotas("default", cpu="10")).obj(), "lq")
        env.submit(WorkloadWrapper("w").queue("lq")
                   .pod_set(count=1, cpu="1").obj())
        env.cycle()
        assert env.scheduler.query_plane is None
        assert env.cache.live_handouts == 0


class TestPositionTables:
    def test_tables_materialize_once_per_view(self):
        q = QEnv(quota=1)
        q.submit(4)
        q.cycle()
        q.settle()
        view = q.qp.acquire()
        try:
            built = q.qp.tables_built
            rows1 = q.qp.pending_cq(view, "cq0", 100, 0)
            assert q.qp.tables_built == built + 1
            rows2 = q.qp.pending_cq(view, "cq0", 100, 0)
            assert q.qp.tables_built == built + 1
            assert [r.name for r in rows1] == [r.name for r in rows2] \
                == ["w1", "w2", "w3"]
            assert [r.position_in_cluster_queue for r in rows1] == [0, 1, 2]
        finally:
            q.qp.release(view)

    def test_nominate_rank_rides_the_seal(self):
        q = QEnv(quota=1)
        q.submit(3)
        q.cycle()
        q.env.queues.queue_inadmissible_workloads({"cq0"})
        q.cycle()
        view = q.qp.acquire()
        try:
            rows = q.qp.pending_cq(view, "cq0", 100, 0)
            ranked = [r for r in rows if r.nominate_rank is not None]
            assert ranked and ranked[0].nominate_rank == 0
        finally:
            q.qp.release(view)

    def test_workload_status_prefers_view_tables(self):
        q = QEnv(quota=1)
        q.submit(3)
        q.cycle()
        q.settle()
        view = q.qp.acquire()
        try:
            q.qp.pending_cq(view, "cq0", 100, 0)
            st = q.qp.workload_status(view, "default", "w1")
            assert st["status"] == "pending"
            assert st["position_in_cluster_queue"] == 0
            st = q.qp.workload_status(view, "default", "w0")
            assert st["status"] == "admitted"
            st = q.qp.workload_status(view, "default", "zzz")
            assert st["found"] is False and st["status"] == "unknown"
            assert view.snap_index["default/w0"] == "cq0"
        finally:
            q.qp.release(view)

    def test_just_admitted_answers_transitioning_not_unknown(self):
        q = QEnv(quota=2)
        q.submit(1)
        q.cycle()
        view = q.qp.acquire()
        try:
            st = q.qp.workload_status(view, "default", "w0")
            assert st["found"] is True
            assert st["status"] in ("transitioning", "admitted")
        finally:
            q.qp.release(view)
        q.submit(1, prefix="x")
        q.cycle()
        view = q.qp.acquire()
        try:
            st = q.qp.workload_status(view, "default", "w0")
            assert st["found"] and st["status"] == "admitted"
        finally:
            q.qp.release(view)


class TestStaleness:
    def test_token_lag_bounded_by_one_seal(self):
        q = QEnv()
        q.submit(2)
        q.cycle()
        assert q.qp.token_lag() == 0
        q.bump_quota(cpu=3)
        assert q.qp.token_lag() == 1
        view = q.qp.acquire()
        assert view.generation != q.cache.generation_token()
        q.qp.release(view)
        q.submit(1, prefix="x")
        q.cycle()
        assert q.qp.token_lag() == 0
        view = q.qp.acquire()
        assert view.generation == q.cache.generation_token()
        q.qp.release(view)

    def test_stamp_and_status_surface(self):
        q = QEnv()
        q.submit(1)
        q.cycle()
        view = q.qp.acquire()
        try:
            stamp = view.stamp()
            assert stamp["generation"] == list(q.cache.generation_token())
            assert stamp["cycle"] == view.cycle_id
            assert stamp["age_s"] >= 0
        finally:
            q.qp.release(view)
        st = q.qp.status()
        assert not st["warming"] and st["token_lag"] == 0
        assert st["cycles_published"] >= 1
        assert st["holds_snapshot_handout"] is True


class TestConcurrentReadVsCycle:
    """tests/test_queryplane.py's randomized concurrent read-vs-cycle
    interleaving on the port: a view is internally consistent, its
    position tables never tear, staleness stays within one seal."""

    @pytest.mark.parametrize("seed", [0, 7])
    def test_interleaved_readers_stay_consistent(self, seed):
        rng = random.Random(seed)
        q = QEnv(cqs=3, quota=2, cohort="co")
        qp, cache = q.qp, q.cache
        stop = threading.Event()
        errors, max_lag, reads = [], [0], [0]

        def reader(idx):
            n = 0
            while not stop.is_set():
                view = qp.acquire()
                if view is None:
                    continue
                try:
                    lag = cache.generation_lag(view.generation)
                    cq = f"cq{(n + idx) % 3}"
                    rows = qp.pending_cq(view, cq, 100, 0)
                    again = qp.pending_cq(view, cq, 100, 0)
                    if [r.name for r in rows] != [r.name for r in again]:
                        errors.append(f"torn table for {cq}")
                    names = [r.name for r in rows]
                    if len(set(names)) != len(names):
                        errors.append(f"duplicate rows: {names}")
                    if [r.position_in_cluster_queue for r in rows] \
                            != list(range(len(rows))):
                        errors.append(f"non-dense positions: {rows}")
                    if tuple(view.stamp()["generation"]) != view.generation:
                        errors.append("stamp token != view token")
                    max_lag[0] = max(max_lag[0], lag)
                    reads[0] += 1
                finally:
                    qp.release(view)
                n += 1

        threads = [threading.Thread(target=reader, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        try:
            edited = False
            for step in range(40):
                op = rng.random()
                if op < 0.55:
                    q.submit(1, lq=f"lq{rng.randrange(3)}",
                             cpu=str(rng.choice([1, 2])), prefix=f"r{seed}-",
                             start=step)
                elif op < 0.7:
                    q.bump_quota(cq=f"cq{rng.randrange(3)}",
                                 cpu=rng.choice([2, 3, 4]))
                    edited = True
                    lag = qp.token_lag()
                    assert lag is None or lag <= 1
                q.env.queues.queue_inadmissible_workloads(
                    set(q.env.cq_names))
                pubs0 = qp.cycles_published
                q.cycle()
                q.env.clock.advance(1.0)
                if qp.cycles_published > pubs0:
                    assert qp.token_lag() == 0
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not errors, errors[:5]
        assert reads[0] > 0 and edited
        assert max_lag[0] <= 2, max_lag[0]
        qp.close()
        assert cache.live_handouts == 0

    def test_read_storm_releases_handouts_on_error_paths(self):
        q = QEnv()
        q.submit(2)
        q.cycle()
        for _ in range(5):
            view = q.qp.acquire()
            try:
                raise RuntimeError("reader died mid-serve")
            except RuntimeError:
                pass
            finally:
                q.qp.release(view)
        q.env.queues.queue_inadmissible_workloads({"cq0"})
        q.cycle()
        q.qp.close()
        assert q.cache.live_handouts == 0


def test_raw_queryplane_on_bare_components():
    env = Env(PORT, "cpu")
    env.add_flavor("default")
    env.add_cq(ClusterQueueWrapper("cq").resource_group(
        flavor_quotas("default", cpu="2")).obj(), "lq")
    qp = mod(PORT, "obs.queryplane").QueryPlane(env.cache, env.queues)
    env.scheduler.query_plane = qp
    env.submit(WorkloadWrapper("w1").queue("lq").pod_set(count=1, cpu="1")
               .obj())
    env.submit(WorkloadWrapper("w2").queue("lq").pod_set(count=1, cpu="4")
               .obj())
    env.cycle()
    view = qp.acquire()
    try:
        assert view is not None
        assert view.generation == env.cache.generation_token()
    finally:
        qp.release(view)
    qp.close()
    assert env.cache.live_handouts == 0
